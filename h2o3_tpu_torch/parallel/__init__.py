"""Multi-process plumbing of the port: the cloud (`mesh`), the host
collectives and the canonical row layout (`distdata`), and the launcher
that forms the cloud before a training script runs (`launcher`)."""
