#!/usr/bin/env python3
"""Time the two ways of building the CUDA kernels of ``repro_torch``.

    python3 tools/ext_build_time.py

Needs one NVIDIA GPU, ``nvcc`` and (for the second way) ``ninja``.  It
builds the three sources of ``src/repro_torch/kernels/csrc`` twice, each
time from nothing:

  nvcc_ctypes    what the port does (``kernels/_build.py``): one ``nvcc -c``
                 per source at once, one link, ``ctypes``
  cpp_extension  ``torch.utils.cpp_extension.load`` over the same sources
                 plus a small ``.cpp`` binding that includes
                 ``torch/extension.h``

calls ``quantize`` through both and checks that they agree, and prints one
JSON line with the seconds of each.  The port does not use the second
way; this script exists so that the choice rests on a number.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ops as kops          # noqa: E402

BINDING = r"""
#include <torch/extension.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int sira_quantize(const void* x, const float* s, const float* z,
                             void* out, long long M, long long C,
                             int per_channel, int qmin, int qmax, int x_kind,
                             int out_kind, void* stream);

torch::Tensor quantize(torch::Tensor x, torch::Tensor s, torch::Tensor z,
                       int64_t qmin, int64_t qmax) {
    TORCH_CHECK(x.is_cuda() && x.is_contiguous() && x.dim() == 2 &&
                x.scalar_type() == torch::kFloat32);
    auto out = torch::empty(x.sizes(), x.options().dtype(torch::kInt32));
    int err = sira_quantize(
        x.data_ptr(), s.data_ptr<float>(), z.data_ptr<float>(),
        out.data_ptr(), x.size(0), x.size(1), s.numel() == x.size(1) && x.size(1) > 1, (int)qmin,
        (int)qmax, 0, 1, c10::cuda::getCurrentCUDAStream().stream());
    TORCH_CHECK(err == 0, "sira_quantize failed to launch: cudaError ", err);
    return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) { m.def("quantize", &quantize); }
"""


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ext_build_time: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    bdir = ROOT / "build" / "ext_build_time"
    shutil.rmtree(bdir, ignore_errors=True)
    bdir.mkdir(parents=True)

    _build.build_dir = lambda: bdir / "nvcc_ctypes"      # build from nothing
    t0 = time.perf_counter()
    _build.load()
    nvcc_s = time.perf_counter() - t0

    from torch.utils import cpp_extension
    os.environ.setdefault("TORCH_CUDA_ARCH_LIST", "9.0a")
    binding = bdir / "binding.cpp"
    binding.write_text(BINDING)
    ext_dir = bdir / "cpp_extension"
    ext_dir.mkdir()
    t0 = time.perf_counter()
    ext = cpp_extension.load(
        name="sira_kernels_ext",
        sources=[str(binding)] + [str(_build.CSRC / s)
                                  for s in _build.SOURCES],
        extra_cuda_cflags=["-O3", "-std=c++17"],
        build_directory=str(ext_dir), verbose=False)
    ext_s = time.perf_counter() - t0

    x = torch.randn(257, 5, device="cuda") * 3
    s = torch.tensor([0.1], device="cuda")
    z = torch.zeros(1, device="cuda")
    got = ext.quantize(x, s, z, -8, 7)
    want = kops.quantize(x, s, z, qmin=-8, qmax=7, out_dtype=torch.int32,
                         use_kernel=True)
    if not torch.equal(got, want):
        sys.exit("ext_build_time: the two builds disagree")
    print(json.dumps(dict(
        nvcc_ctypes_s=round(nvcc_s, 2), cpp_extension_s=round(ext_s, 2),
        sources=len(_build.SOURCES), torch=torch.__version__,
        cuda=torch.version.cuda, cpus=os.cpu_count(), nvidia_smi=smi)))


if __name__ == "__main__":
    main()
