"""Elastic epochs of the socket cluster: the state a replacement party
loads.

Of the reference's `distributed/elastic.py` only `party_handoff_plan`
serves the VFL cluster; its mesh resharding (`replace_onto_mesh`,
`shard_plan`) belongs to the language-model side (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

import hashlib
import os

from repro_torch.checkpoint import party_checkpoint_dir


def party_handoff_plan(checkpoint_root: str, name: str,
                       step: int | None = None) -> dict:
    """The exact files (and byte counts) a REPLACEMENT party must load to
    take over a quarantined party's role at an epoch boundary.

    The supervisor (`launch.cluster.train_vfl_socket_resilient`) calls
    this before admitting a standby replica: party state is durable only
    as `<root>/party_<name>/step_<n>.{npz,json}` checkpoints (weights,
    stream cursors, meter ledgers — never key material, which is
    re-derived from the seed), so the handoff IS this manifest.
    `step=None` picks the newest step that has both archive and manifest
    on disk; an empty plan (step 0, no files) means the replacement
    starts the roll-back-and-replay from scratch.
    """
    directory = party_checkpoint_dir(checkpoint_root, name)
    chosen, files = 0, []
    if os.path.isdir(directory):
        steps = sorted({int(f.split("_")[1].split(".")[0])
                        for f in os.listdir(directory)
                        if f.startswith("step_") and f.endswith(".json")},
                       reverse=True)
        for s in steps:
            if step is not None and s != step:
                continue
            paths = [os.path.join(directory, f"step_{s}{ext}")
                     for ext in (".npz", ".json")]
            if not all(os.path.isfile(p) for p in paths):
                continue
            chosen = s
            files = []
            for p in paths:            # integrity fingerprint per file:
                with open(p, "rb") as f:     # the replacement re-hashes
                    digest = hashlib.sha256(f.read()).hexdigest()
                files.append({"path": p, "bytes": int(os.path.getsize(p)),
                              "sha256": digest})
            break
    return {"party": name, "step": int(chosen), "files": files,
            "total_bytes": int(sum(f["bytes"] for f in files))}
