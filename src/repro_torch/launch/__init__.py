"""Launchers: the layout of a ``torch.distributed`` job (``mesh.py``),
the partition specs and the slicing of weights to a rank's block
(``shardings.py``), the training launcher (``train.py``), the dry run of
every cell (``dryrun.py``) and the multi-process runner of the
tensor-parallel checks (``ranks.py``)."""
