"""Readings that the limits of `correct` are set from, at a cell's own size.

    python3 -m vflbench.control --workload t1_lr.full --mode program \\
        --seeds 11,12,13 --seconds 30 --out readings.jsonl

Runs the cell's whole run (set-up, window, comparison) once a seed in one
process and appends each run's compared numbers to `--out`.  Modes:

  program         the program as the configuration states it (the lower
                  readings)
  control         the program one step of precision below: features in
                  16-bit exponents, the configuration's `control` settings
                  (fx 8, exp_width 16), judged against the same reference
  half_batch      fault: every party trains on the first half of each
                  batch, the mean taken over it
  exchange        fault: a party drops the unmasked share that comes back
                  from the other key owner (the parties' exchange left out)
  altered         fault: one decrypted value altered where it is produced
  unchanged       fault: the update leaves the weights as they were

The benchmark's own runs never run this; it runs on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("program", "control", "half_batch", "exchange", "altered",
         "unchanged")


@contextlib.contextmanager
def planted(mode: str):
    """The program with one fault in place for the duration."""
    from repro_torch.core import protocols
    from repro_torch.crypto import ring
    from repro_torch.runtime import party
    saved = []

    def patch(obj, name, fn):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    if mode == "half_batch":
        orig = party.Party.begin_iteration

        def begin(self, idx, cps, nb, mask_bound):
            h = nb // 2
            return orig(self, idx[:h], cps, h, mask_bound)
        patch(party.Party, "begin_iteration", begin)
    elif mode == "exchange":
        def absorb(self, m):
            self._masks.pop(m.src)
            self._pending_unmask.discard(m.src)
            if not self._pending_unmask and self._grad_ready:
                self._apply_update()
        patch(party.Party, "_absorb_unmasked", absorb)
    elif mode == "altered":
        orig_dec = protocols.PaillierBackend.decrypt_to_r64

        def dec(self, p, cts):
            out = orig_dec(self, p, cts)
            lo = out.lo.clone()
            lo[0] = (lo[0] + 1) & ring.M32
            return ring.R64(out.hi, lo)
        patch(protocols.PaillierBackend, "decrypt_to_r64", dec)
    elif mode == "unchanged":
        patch(party.Party, "_apply_update", lambda self: None)
    try:
        yield
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def reading(workload: str, mode: str, seed: int, seconds: float) -> dict:
    from vflbench import bench, spec
    overrides = {}
    if mode == "control":
        overrides.update(spec.cell(workload).config["control"])
    t0 = time.perf_counter()
    with planted(mode):
        out = bench.run_cell(workload, seed, seconds, False, "cuda", t0,
                             overrides=overrides)
    return {"workload": workload, "mode": mode, "seed": seed,
            "iterations": out["attempted"], "correct": out["correct"],
            "numbers": {k: c["value"] for k, c in out["checks"].items()},
            "s_per_iter": out["metrics"]["s_per_iter"]["value"],
            "device": out["device"]["kind"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = reading(args.workload, args.mode, seed, args.seconds)
            print(json.dumps(r), flush=True)
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
