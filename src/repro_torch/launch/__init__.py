"""Launchers: the localhost socket cluster of party processes
(`launch.cluster`), device meshes over a `torch.distributed` world
with `run_world`, which spawns one on this host (`launch.mesh`), the
secure dry-run: the Protocol-3 step on a pod × data × model world
(`launch.secure_dryrun`) with the H100 hardware model and measurement
helpers it reports through (`launch.dryrun`), and the LM side's
training driver (`launch.train`), its step builders (`launch.steps`)
and the analytic cost model (`launch.costmodel`)."""
