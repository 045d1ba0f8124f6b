"""Probes and profiles of the measuring path, each run as
`python -m zklaim_tpu_torch.tools.<name>` (on the card unless `--device cpu`).

Counterparts of the scripts under tools/ of the repository's root, with the
same names.  A module does no work at import; `measure(device)` returns the
rows its `main()` prints.
"""
