#!/usr/bin/env python3
"""Time the port's one-child f32 tree_combine kernel under other grids.

    python3 scripts/tree_combine_grid.py

At the training path's reduce-hop shape (one child of 1,076,120,064 f32
elements, all 16-byte aligned), on one CUDA card, it times
``torch.add(partial, recv)``, the kernel through its wrapper (one block
for each 256 x 4 vectors: one pass over the data in address order) and
the same kernel as a persistent grid-stride loop of k blocks per SM, for
k = 1, 2, 4 and the kernel's occupancy.  The variants launch the shipped
``tree_combine_kernel<float, 1>`` from ``tree_combine.cu`` unchanged,
through a small C entry point that this script compiles with the port's
``nvcc`` flags and that takes the grid as an argument.  Every variant's
output must equal ``torch.add``'s bit for bit.  Times are those of
``chip_smoke.py``'s ``timed`` (the median of 5 rounds of about 20 ms),
over two passes in opposite orders; it prints each pass's ms, the ratio
to ``torch.add``, and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LENGTH = 1_076_120_064         # 16 vertices x one torus chunk row

WRAPPER = """// tree_combine.cu sha256 {digest}
#include "{source}"
extern "C" int tree_combine_f32_grid(const void* recv, const void* partial,
                                     void* out, int64_t len, int64_t blocks,
                                     void* stream) {{
  // len % 4 == 0 and every pointer 16-byte aligned: no scalar head or tail
  tree_combine_kernel<float, 1><<<(unsigned int)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const float*)recv, (const float*)partial, (float*)out, 1, len, 0,
      len / 4);
  return (int)cudaGetLastError();
}}
extern "C" int tree_combine_f32_occupancy(int* blocks_per_sm) {{
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tree_combine_kernel<float, 1>, kThreads, 0);
}}
"""


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("tree_combine_grid: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import timed
    from repro_torch.kernels._build import Library, build_dir
    from repro_torch.kernels.tree_combine import kernel as K

    source = K.LIB.source
    wrapper = build_dir() / "tree_combine_grid.cu"
    wrapper.parent.mkdir(parents=True, exist_ok=True)
    wrapper.write_text(WRAPPER.format(
        digest=hashlib.sha256(source.read_bytes()).hexdigest(),
        source=source))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = Library(wrapper, "tree_combine_grid", {
        "tree_combine_f32_grid": [p, p, p, i64, i64, p],
        "tree_combine_f32_occupancy": [p]}).load()

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    part = torch.randn((LENGTH,), generator=g, device=dev)
    recv = torch.randn((1, LENGTH), generator=g, device=dev)
    out = torch.empty_like(part)
    stream = torch.cuda.current_stream(dev).cuda_stream
    occ = ctypes.c_int(0)
    assert lib.tree_combine_f32_occupancy(ctypes.byref(occ)) == 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def grid(blocks):
        def run():
            err = lib.tree_combine_f32_grid(recv.data_ptr(), part.data_ptr(),
                                            out.data_ptr(), LENGTH, blocks,
                                            stream)
            assert err == 0, err
            return out
        return run

    variants = {"torch.add": lambda: torch.add(part, recv[0]),
                "wrapper (one pass)": lambda: K.tree_combine(recv, part)}
    for k in sorted({1, 2, 4, occ.value}):
        variants[f"persistent {k}/SM ({k * sms} blocks)"] = grid(k * sms)
    want = torch.add(part, recv[0])
    for name, fn in variants.items():
        assert torch.equal(fn(), want), name
    del want
    ms = {name: [] for name in variants}
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            ms[name].append(timed(variants[name]))
    print(f"tree_combine f32, one child, {LENGTH} elements; {sms} SMs, "
          f"occupancy {occ.value} blocks of 256 threads per SM")
    for name, t in ms.items():
        ratio = [x / y for x, y in zip(t, ms["torch.add"])]
        print(f"  {name}: {t!r} ms, {ratio!r} x torch.add")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())


if __name__ == "__main__":
    main()
