"""MeshLab project (.mlp) read/write.

The port of the reference package's MeshLab IO (reference C++:
libvis/src/libvis/external_io/meshlab_project.h:43-76 — per-mesh label,
filename and 4x4 mesh-to-global transform).  The .mlp format is the small
MeshLabDocument XML; filenames may be relative to the project file.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np


@dataclasses.dataclass
class MeshLabMeshInfo:
    label: str
    filename: str
    global_tr_mesh: np.ndarray  # (4, 4)


def write_meshlab_project(path, meshes):
    """Write a MeshLab project referencing ``meshes``.

    meshes: iterable of MeshLabMeshInfo (or (label, filename, 4x4) tuples).
    """
    root = ET.Element("MeshLabProject")
    group = ET.SubElement(root, "MeshGroup")
    for m in meshes:
        if not isinstance(m, MeshLabMeshInfo):
            m = MeshLabMeshInfo(*m)
        mesh_el = ET.SubElement(
            group, "MLMesh", label=m.label, filename=m.filename
        )
        mat = np.asarray(m.global_tr_mesh, np.float64).reshape(4, 4)
        rows = "\n".join(
            " ".join(format(v, ".17g") for v in row) for row in mat
        )
        mat_el = ET.SubElement(mesh_el, "MLMatrix44")
        mat_el.text = "\n" + rows + "\n"
    with open(path, "w") as f:
        f.write("<!DOCTYPE MeshLabDocument>\n")
        f.write(ET.tostring(root, encoding="unicode"))
        f.write("\n")


def read_meshlab_project(path):
    """Read a .mlp; returns a list of MeshLabMeshInfo (identity transform
    when a mesh has no MLMatrix44 element)."""
    with open(path) as f:
        text = f.read()
    # strip the non-XML doctype line MeshLab writes
    text = "\n".join(
        ln for ln in text.splitlines() if not ln.startswith("<!DOCTYPE")
    )
    root = ET.fromstring(text)
    out = []
    for mesh_el in root.iter("MLMesh"):
        mat = np.eye(4)
        mat_el = mesh_el.find("MLMatrix44")
        if mat_el is not None and mat_el.text:
            vals = [float(v) for v in mat_el.text.split()]
            if len(vals) == 16:
                mat = np.asarray(vals).reshape(4, 4)
        out.append(
            MeshLabMeshInfo(
                label=mesh_el.get("label", ""),
                filename=mesh_el.get("filename", ""),
                global_tr_mesh=mat,
            )
        )
    return out


def export_stereo_project(path, cloud_files, poses=None):
    """Convenience: one .mlp referencing exported point clouds.

    cloud_files: list of cloud paths (made relative to the project dir);
    poses: optional list of (R, t) global_tr_cloud transforms.
    """
    base = os.path.dirname(os.path.abspath(path))
    meshes = []
    for i, cf in enumerate(cloud_files):
        mat = np.eye(4)
        if poses is not None and poses[i] is not None:
            r, t = poses[i]
            mat[:3, :3] = np.asarray(r)
            mat[:3, 3] = np.asarray(t)
        meshes.append(
            MeshLabMeshInfo(
                label=os.path.splitext(os.path.basename(cf))[0],
                filename=os.path.relpath(os.path.abspath(cf), base),
                global_tr_mesh=mat,
            )
        )
    write_meshlab_project(path, meshes)
