"""Multi-process scaling of bundle adjustment over ``torch.distributed``:
observation sharding (``sharding``) and the multi-host set-up
(``distributed``).  One process drives one device."""
