"""The port's card tools in ``tools/``, on the CPU.

``compare_kernels.py`` needs a card: without one it must exit non-zero and
print no result.  Its SASS reading is plain text work and is checked here
on a listing in the form ``cuobjdump -sass`` prints.
"""

import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / "tools"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "compare_kernels", TOOLS / "compare_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernels", [None, "project,project_blocks"])
def test_compare_tool_refuses_without_a_card(kernels):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    extra = [] if kernels is None else ["--kernels", kernels]
    r = subprocess.run(
        [sys.executable, str(TOOLS / "compare_kernels.py"),
         "--other", str(REPO), *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"rows"' not in r.stdout


def test_compare_tool_refuses_an_unknown_kernel():
    r = subprocess.run(
        [sys.executable, str(TOOLS / "compare_kernels.py"),
         "--other", str(REPO), "--kernels", "project,nope"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "nope" in r.stderr


# Two kernels in cuobjdump's layout: the first with a staging loop
# (0x0030-0x0050) and an LM loop (0x0070-0x00d0) inside an outer loop
# (0x0060-0x00e0), the second with none.
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114project_kernelILb1ELb0EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x0 */
                                                                     /* 0x0 */
        /*0010*/                   S2R R0, SR_TID.X ;               /* 0x0 */
        /*0020*/                   NOP ;                            /* 0x0 */
        /*0030*/                   LDG.E R2, desc[UR4][R2.64] ;     /* 0x0 */
        /*0040*/                   STS [R0], R2 ;                   /* 0x0 */
        /*0050*/              @!P0 BRA 0x30 ;                       /* 0x0 */
        /*0060*/                   LDS.128 R4, [R0] ;               /* 0x0 */
        /*0070*/                   LDS.128 R8, [R0+0x10] ;          /* 0x0 */
        /*0080*/                   LDS R12, [R0+0x20] ;             /* 0x0 */
        /*0090*/                   MUFU.RSQ R13, R12 ;              /* 0x0 */
        /*00a0*/                   FFMA R14, R13, R4, R5 ;          /* 0x0 */
        /*00b0*/                   FCHK P1, R14, R13 ;              /* 0x0 */
        /*00c0*/               @P1 CALL.REL.NOINC 0x100 ;           /* 0x0 */
        /*00d0*/               @P2 BRA 0x70 ;                       /* 0x0 */
        /*00e0*/               @P3 BRA 0x60 ;                       /* 0x0 */
        /*00f0*/                   EXIT ;                           /* 0x0 */
        /*0100*/                   MUFU.RCP R15, R14 ;              /* 0x0 */
        /*0110*/                   RET.REL.NODEC R2 0x0 ;           /* 0x0 */
        /*0120*/                   BRA 0x120;                       /* 0x0 */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_114project_kernelILb0ELb1EEEvNS_4ArgsE
        /*0000*/                   MUFU.RCP R1, R2 ;                /* 0x0 */
        /*0010*/                   EXIT ;                           /* 0x0 */
"""


def test_sass_counts_of_kernels_and_their_loops():
    tool = _tool()
    fns = tool.parse_sass(SASS)
    assert len(fns) == 2
    first, second = fns.values()
    assert len(first) == 19 and len(second) == 2
    assert tool.sass_counts(first) == {
        "instructions": 18, "MUFU": 2, "FCHK": 1, "CALL": 1, "LDS": 3,
        "LDS.128": 2}
    loop = tool.innermost_loop(first)
    assert [pc for pc, _ in loop] == list(range(0x70, 0xd1, 0x10))
    assert tool.sass_counts(loop) == {
        "instructions": 7, "MUFU": 1, "FCHK": 1, "CALL": 1, "LDS": 2,
        "LDS.128": 1}
    assert tool.innermost_loop(second) == []


def test_sass_labels_name_every_template_argument(monkeypatch, tmp_path):
    tool = _tool()
    listing = SASS.replace("ILb1ELb0EEEv", "ILb1ELi1024EEEv").replace(
        "ILb0ELb1EEEv", "ILb1ELi256EEEv")
    fake = types.SimpleNamespace(nvcc_path=lambda: str(tmp_path / "nvcc"),
                                 build=lambda: tmp_path)
    monkeypatch.setattr(tool.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=listing))
    rows = tool.projection_sass(fake)
    assert sorted(rows) == ["project_kernel<true, 1024>",
                            "project_kernel<true, 256>"]
    assert rows["project_kernel<true, 1024>"]["loop"]["instructions"] == 7
