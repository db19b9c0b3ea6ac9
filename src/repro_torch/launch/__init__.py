"""Entry points of the port (``python -m repro_torch.launch.<name>``).

``serve`` -- continuous-batching serving through ``Engine`` or
``StreamEngine``, optionally under ``ServeSupervisor``.
``train`` -- the AdamW trainer under ``ResilientLoop`` (checkpoints,
restart and replay).
``dryrun`` -- every (arch x shape) cell laid out on the 16x16 and
2x16x16 production mesh shapes, analytically (``mesh`` holds the meshes,
``specs`` the abstract sharded inputs).
``pipeline_demo`` -- the cross-pod mode: a train step with its stages on
the ranks of ``pod`` (run under a process group), and the analytic
record of its cell on the 2x16x16 mesh (no process group needed).
"""
