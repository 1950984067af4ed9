"""The port stands alone: importing every module of ``repro_torch`` pulls
in neither ``jax`` nor the JAX package, and an entry point called without
``device=`` goes to the card, so on a machine without one it raises
instead of running on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps([names, bad]))
"""

#: modules of the port that must import with the rest
PORTED = ("repro_torch.kernels.instrumented_matmul",
          "repro_torch.core.tools.kernel_freq",
          "repro_torch.core.tools.timeline", "repro_torch.models.mamba2",
          "repro_torch.models.moe", "repro_torch.configs.zamba2_7b",
          "repro_torch.configs.mamba2_2_7b", "repro_torch.configs.dbrx_132b",
          "repro_torch.launch.analyze", "repro_torch.kernels.ops",
          "repro_torch.train", "repro_torch.train.trainer",
          "repro_torch.train.optimizer", "repro_torch.train.data",
          "repro_torch.core.capture", "repro_torch.core.tools.roofline",
          "repro_torch.launch.quickstart", "repro_torch.configs.qwen3_32b",
          "repro_torch.configs.kimi_k2_1t_a32b",
          "repro_torch.configs.musicgen_large", "repro_torch.serve",
          "repro_torch.serve.cache", "repro_torch.serve.scheduler",
          "repro_torch.serve.slo", "repro_torch.serve.traffic",
          "repro_torch.serve.faults", "repro_torch.serve.draft",
          "repro_torch.serve.engine", "repro_torch.core.tools.serving",
          "repro_torch.launch.serve", "repro_torch.dist",
          "repro_torch.dist.sharding", "repro_torch.dist.collectives",
          "repro_torch.dist.pipeline", "repro_torch.launch.mesh",
          "repro_torch.launch.train", "repro_torch.train.checkpoint",
          "repro_torch.train.elastic")


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    names, bad = json.loads(r.stdout)
    assert len(names) >= 30
    assert set(PORTED) <= set(names)
    assert bad == []


def test_default_device_is_the_card():
    """Without ``device=`` the reduction goes to CUDA: it raises here
    rather than quietly running the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the kernel would run")
    starts = np.array([2 << 20])
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.object_histogram(starts, starts, starts + 512)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.trace_aggregate(starts, [0.0], starts, starts + 512, 2 << 20,
                            8, 2, 1.0)


def test_quickstart_defaults_to_the_card():
    """``launch.quickstart.run`` without ``device=`` makes its weights on
    CUDA: it raises here rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the quickstart would run")
    import repro_torch.configs as configs
    from repro_torch.launch import quickstart
    with pytest.raises((RuntimeError, AssertionError)):
        quickstart.run(configs.reduced(configs.get("paper-gpt2")))


def test_serve_launcher_defaults_to_the_card():
    """``python -m repro_torch.launch.serve`` without ``--device`` builds
    its weights on CUDA: it fails here rather than serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the launcher would serve")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "paper-gpt2", "--reduced",
                        "--num-requests", "1", "--max-new-tokens", "1"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert "CUDA" in r.stderr or "cuda" in r.stderr
    assert "[serve] 1 requests" not in r.stdout
