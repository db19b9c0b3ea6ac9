"""Entry points of the port (``python -m repro_torch.launch.<name>``).

``serve`` -- continuous-batching serving through ``Engine`` or
``StreamEngine``, optionally under ``ServeSupervisor``.  The training,
mesh and dry-run launchers of the reference are not ported yet (ROADMAP
A10-A12).
"""
