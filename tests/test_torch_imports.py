"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py``) import
neither ``jax`` nor the JAX package ``repro``, proven in a fresh process
that runs the port's QNN main path and one reduced LM prefill, and by a
scan of the sources."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]

_PROBE = """
import sys
import numpy as np
import repro_torch
import torch
import repro_torch.core, repro_torch.kernels, repro_torch.obs
import repro_torch.configs, repro_torch.models, repro_torch.quant
from repro_torch.core import build_flow
from repro_torch.core.workloads import WORKLOADS
model = build_flow(WORKLOADS["TFC-w2a2"]()).model
compiled = model.compile(device="cpu")
feeds = next(iter(model.sample_inputs(rng=np.random.default_rng(0))))
out = compiled(feeds)
assert all(np.isfinite(v).all() for v in out.values())
from repro_torch.configs import get_config
from repro_torch.models import get_model
cfg = get_config("gemma2-2b", reduced=True)
lm = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
logits = lm(torch.randint(0, cfg.vocab, (2, 40)))
assert logits.shape == (2, 40, cfg.vocab_padded)
assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED=" + ",".join(bad))
"""


def test_port_runs_without_jax_or_the_reference_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LEAKED=\n" in proc.stdout, proc.stdout


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_neither_jax_nor_repro(path):
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    hits = [f"{i}: {line}" for i, line in
            enumerate(path.read_text().splitlines(), 1) if pat.match(line)]
    assert not hits, hits
