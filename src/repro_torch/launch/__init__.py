"""Entry points of the port (``python -m repro_torch.launch.<name>``).

``serve`` -- continuous-batching serving through ``Engine`` or
``StreamEngine``, optionally under ``ServeSupervisor``.
``train`` -- the AdamW trainer under ``ResilientLoop`` (checkpoints,
restart and replay).  The mesh and dry-run launchers of the reference
are not ported yet (ROADMAP A11-A12).
"""
