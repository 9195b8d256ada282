"""The port stands alone: importing every module of `sgtapose_tpu_torch` and
`chip_smoke` loads no `jax`, `flax` or `sgtapose_tpu` module, starts no
build, and `chip_smoke` only defines `main` (run under `__main__`)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import sgtapose_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    sgtapose_tpu_torch.__path__, "sgtapose_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from sgtapose_tpu_torch.ops import build
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sgtapose_tpu"))
print(json.dumps({"modules": names, "bad": bad, "libs": len(build._LIBS)}))
"""


def test_port_imports_no_jax_and_builds_nothing():
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    assert res["libs"] == 0
    expected = {"sgtapose_tpu_torch.infer.detector", "sgtapose_tpu_torch.models.sgta",
                "sgtapose_tpu_torch.ops.attention_kernel", "sgtapose_tpu_torch.models.deform_conv",
                "sgtapose_tpu_torch.utils.weights", "sgtapose_tpu_torch.core.pnp",
                "sgtapose_tpu_torch.utils.precision", "sgtapose_tpu_torch.eval.metrics",
                "sgtapose_tpu_torch.eval.analysis", "sgtapose_tpu_torch.eval.synthetic_eval",
                "sgtapose_tpu_torch.data.pipeline", "sgtapose_tpu_torch.train.loss",
                "sgtapose_tpu_torch.train.schedule", "sgtapose_tpu_torch.train.phases",
                "sgtapose_tpu_torch.train.trainer", "sgtapose_tpu_torch.cli.train_demo",
                "sgtapose_tpu_torch.cli.infer", "sgtapose_tpu_torch.data.loaders",
                "sgtapose_tpu_torch.data.synthetic", "sgtapose_tpu_torch.infer.tracker",
                "sgtapose_tpu_torch.utils.profiling", "sgtapose_tpu_torch.utils.visualize",
                "sgtapose_tpu_torch.utils.debugger", "sgtapose_tpu_torch.data.discovery",
                "sgtapose_tpu_torch.data.loader", "sgtapose_tpu_torch.utils.logging",
                "sgtapose_tpu_torch.parallel.mesh", "sgtapose_tpu_torch.cli.train",
                "sgtapose_tpu_torch.models.variants", "sgtapose_tpu_torch.utils.torch_convert",
                "sgtapose_tpu_torch.cli.convert", "sgtapose_tpu_torch.models.dream_baselines",
                "sgtapose_tpu_torch.data.image_space", "sgtapose_tpu_torch.infer.dream_detector",
                "sgtapose_tpu_torch.native", "sgtapose_tpu_torch.parallel.multihost_dryrun",
                "sgtapose_tpu_torch.utils.seeding"}
    assert expected <= set(res["modules"])


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No GPU here: chip_smoke exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
