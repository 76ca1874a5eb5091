"""Launchers: the localhost socket cluster of party processes
(`launch.cluster`), and device meshes over a `torch.distributed` world
with `run_world`, which spawns one on this host (`launch.mesh`)."""
