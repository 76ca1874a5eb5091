"""Launchers: the localhost socket cluster of party processes
(`launch.cluster`), device meshes over a `torch.distributed` world
with `run_world`, which spawns one on this host (`launch.mesh`), and
the secure dry-run: the Protocol-3 step on a pod × data × model world
(`launch.secure_dryrun`) with the H100 hardware model and measurement
helpers it reports through (`launch.dryrun`)."""
