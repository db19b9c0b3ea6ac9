"""Entry points of the port (``python -m repro_torch.launch.<name>``).

``serve`` -- continuous-batching serving through ``Engine`` or
``StreamEngine``, optionally under ``ServeSupervisor``.
``train`` -- the AdamW trainer under ``ResilientLoop`` (checkpoints,
restart and replay).
``dryrun`` -- every (arch x shape) cell laid out on the 16x16 and
2x16x16 production mesh shapes, analytically (``mesh`` holds the meshes,
``specs`` the abstract sharded inputs).  The reference's
``pipeline_demo`` (a compiled pipelined train step on the 2x16x16 mesh)
is not ported.
"""
