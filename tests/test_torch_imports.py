"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py``) import
neither ``jax`` nor the JAX package ``repro``, proven in a fresh process
that runs the port's QNN main path (affine domain, dataflow steps), the
fuzzer, one reduced LM prefill, three QAT steps with their export, a
serving engine answering two requests (SIRA-int8 cache), a dry-run cell
and ``compressed_psum`` over a one-rank layout, and by a scan of the
sources."""
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
import repro_torch.dataflow, repro_torch.dataflow.report
from repro_torch.core import DATAFLOW_STEPS, build_flow, run_fuzz
from repro_torch.core.workloads import WORKLOADS
model = build_flow(WORKLOADS["TFC-w2a2"](), domain="affine",
                   steps=DATAFLOW_STEPS).model
assert model.metadata["dataflow_report"].lut_reduction > 0
assert run_fuzz(n_random=2, workloads=False).ok
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
import repro_torch.optim, repro_torch.train, repro_torch.data
from repro_torch.qat import QATConfig, proven_layer_bits, run_qat
res = run_qat(QATConfig(budget=12, steps=3, hidden=(8,)), device="cpu")
assert len(res.losses) == 3 and np.isfinite(res.losses).all()
_, bits = proven_layer_bits(res.model, res.state.params)
assert max(bits) <= 12
import repro_torch.serve
from repro_torch.serve import Request, ServingConfig, ServingEngine
qwen = get_model(get_config("qwen2-1.5b", reduced=True), device="cpu").init(
    torch.Generator().manual_seed(0))
eng = ServingEngine(qwen, ServingConfig(batch_slots=2, max_seq=32,
                                        kv_cache="sira-int8"))
outs = eng.generate([Request(prompt=np.arange(5), max_new_tokens=3),
                     Request(prompt=np.arange(7), max_new_tokens=2,
                             temperature=1.0)])
assert [len(o) for o in outs] == [3, 2] and eng.kv_spec.n_int8 == 2
import repro_torch.launch.mesh, repro_torch.launch.shardings
import repro_torch.launch.dryrun, repro_torch.launch.ranks
import repro_torch.roofline, repro_torch.roofline.report
from repro_torch.launch.dryrun import run_cell
cell = run_cell("qwen2-1.5b", "decode_32k")
assert cell.ok and cell.roofline["bottleneck"] == "memory"
from repro_torch.launch.mesh import make_layout, use_layout
from repro_torch.train import compressed_psum
with use_layout(make_layout((1, 1))):
    assert compressed_psum(torch.ones(3), "model").shape == (3,)
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
