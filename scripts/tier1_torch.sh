#!/usr/bin/env bash
# The PyTorch/CUDA port's CPU gate, from the repo root: the port's tests
# (each holds a module of src/repro_torch/ to the JAX package on the same
# inputs; the card-only tests skip without one), then the four example
# twins of examples_torch/ at smoke sizes on the CPU.  No benchmark runs
# here yet.
#   bash scripts/tier1_torch.sh [extra pytest args]
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_*.py "$@"
python examples_torch/quickstart.py --torch-device cpu
python examples_torch/sira_report.py --torch-device cpu
python examples_torch/sira_report.py --torch-device cpu \
    --workload TFC-w2a2 --verify
python examples_torch/serve_quantized.py --torch-device cpu
python examples_torch/train_qat.py --torch-device cpu --steps 20
