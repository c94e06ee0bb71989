"""Multi-stream parallelism: the shared rate pool over a process group."""
