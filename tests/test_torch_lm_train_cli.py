"""Port, the training driver `launch.train` on the CPU: a run killed at a
step (``--die-at-step``: `SystemExit(42)`) and resumed (``--resume``)
ends with a final checkpoint equal, array for array, to an uninterrupted
run's; the result dict carries the reference's keys; bfloat16 weights
go to the archive as their bits.  The reference's slow
test_kill_and_resume_bitwise_identical has its counterpart at its size
(60 steps, subprocesses), marked slow like the original."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--arch", "gpt-100m", "--smoke", "--device", "cpu", "--batch",
          "2", "--seq", "16", "--ckpt-every", "2", "--log-every", "1000"]


def _final(d, step):
    with open(os.path.join(d, f"step_{step}.json")) as f:
        manifest = json.load(f)
    return manifest, np.load(os.path.join(d, f"step_{step}.npz"))


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    full, fail = str(tmp_path / "full"), str(tmp_path / "fail")
    res = train.main(COMMON + ["--steps", "6", "--ckpt-dir", full])
    assert {"first_loss", "final_loss", "steps", "params"} <= set(res)
    assert res["steps"] == 6 and isinstance(res["params"],
                                            torch.nn.Module)
    with pytest.raises(SystemExit) as died:
        train.main(COMMON + ["--steps", "6", "--ckpt-dir", fail,
                             "--die-at-step", "3"])
    assert died.value.code == 42
    resumed = train.main(COMMON + ["--steps", "6", "--ckpt-dir", fail,
                                   "--resume"])
    # from the step-2 save, or from scratch where the kill beat its
    # writer thread (a torn checkpoint is never read)
    assert resumed["steps"] in (4, 6)
    assert resumed["final_loss"] == res["final_loss"]
    ma, na = _final(full, 6)
    mb, nb = _final(fail, 6)
    assert ma["step"] == mb["step"] == 6 and ma["dtypes"] == mb["dtypes"]
    assert sorted(na.files) == sorted(nb.files)
    for k in na.files:
        np.testing.assert_array_equal(na[k], nb[k], err_msg=k)
    # bfloat16 weights as their uint16 bits; the optimizer's moments f32
    assert "uint16" in ma["dtypes"] and "float32" in ma["dtypes"]
    model = res["params"]
    bits = {k: p.detach().view(torch.uint16).numpy()
            for k, p in model.named_parameters()}
    stored = [na[f"leaf_{i}"] for i, dt in enumerate(ma["dtypes"])
              if dt == "uint16"]
    assert sorted(a.tobytes() for a in stored) == \
        sorted(a.tobytes() for a in bits.values())


@pytest.mark.slow
def test_kill_and_resume_bitwise_identical_subprocess(tmp_path):
    """Train 60 steps in one go vs. die at 30 + resume: identical params."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    common = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
              "gpt-100m", "--smoke", "--device", "cpu", "--batch", "2",
              "--seq", "32", "--ckpt-every", "10", "--log-every", "1000"]
    d_full, d_fail = str(tmp_path / "full"), str(tmp_path / "fail")
    r = subprocess.run(common + ["--steps", "60", "--ckpt-dir", d_full],
                       env=env, capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    r = subprocess.run(common + ["--steps", "60", "--ckpt-dir", d_fail,
                                 "--die-at-step", "30"],
                       env=env, capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 42
    r = subprocess.run(common + ["--steps", "60", "--ckpt-dir", d_fail,
                                 "--resume"],
                       env=env, capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    ma, na = _final(d_full, 60)
    mb, nb = _final(d_fail, 60)
    assert ma["step"] == mb["step"] == 60
    assert sorted(na.files) == sorted(nb.files)
    for k in na.files:
        np.testing.assert_array_equal(na[k], nb[k], err_msg=k)


def test_training_and_distribution_modules_import_without_jax():
    """The slice's modules import with `jax` and `repro` unimportable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro', 'ml_dtypes'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.elastic\n"
        "import repro_torch.distributed.flash_decode\n"
        "import repro_torch.distributed.compression\n"
        "import repro_torch.launch.costmodel, repro_torch.launch.steps\n"
        "import repro_torch.launch.train\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
