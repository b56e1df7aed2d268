"""Instruction mix of the sampler's kernels, read from their SASS.

    python -m mvskit_tpu_torch.tools.sass_mix [--lib LIB] [--throughput] [--out FILE]

Disassembles the kernel library (LIB, default: this checkout's, built
if needed; another checkout's `build/mvskit_tpu_torch/<hash>/
libmvskit_kernels.so` to compare two) with `cuobjdump -sass`, and for
each kernel instance (demangled as in ``ops/_build.ptxas_report``:
``window_kernel<3, 7, 0>``, ``fused_kernel<1, 7, 0>``) finds its
sampling loop: the innermost loop (a backward branch) that holds global
loads. It counts the loop body's instructions by class
(``CLASSES``: integer-divide sequences, conversions, shared and global
loads and stores, FP32, PRMT, integer, other) and divides them by the
samples one pass of the loop takes, counted from its global loads (4
per RGB sample, 1 per luma sample; the backward's first design also
loads each sample's C cotangent floats, 7 and 2): the instructions each
sample issues in the loop. What the loop runs once per group or tile is
left out; where the loop is a whole tile that reduces by shuffles after
its samples (the backward's staged design), ``walk_per_sample_total``
counts the walk alone, from the loop's first global load to its first
shuffle.

With ``--throughput`` it also builds a small probe library with nvcc and
times, on the card, long chains of one instruction kind (FADD; I2F;
F2I; PRMT; FMNMX; the window kernel's byte conversion, shift, mask and
I2F; K4's byte_f32, PRMT and FADD) over every SM, reporting each kind's
rate against FADD's. Prints one JSON object; FILE receives it too.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

from ..ops import _build

# instruction classes, by opcode (the part before the first '.')
CLASSES = (
    ("conv", ("I2F", "F2I", "I2FP", "F2IP", "F2F", "I2I")),
    ("lds", ("LDS",)),
    ("sts", ("STS",)),
    ("ldg", ("LDG",)),
    ("stg", ("STG",)),
    ("fp32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FMUL32I",
              "FADD32I", "FFMA32I")),
    ("prmt", ("PRMT",)),
    ("int", ("IMAD", "IADD3", "IADD", "LEA", "SHF", "LOP3", "ISETP", "IMNMX", "SEL", "IABS",
             "MOV", "SHL", "SHR", "IADD32I", "LOP32I", "IMUL", "ULDC", "S2R", "CS2R", "UMOV",
             "UIADD3", "ULEA", "USHF", "UIMAD", "ULOP3", "USEL", "UISETP", "P2R", "R2P",
             "PLOP3", "VIADD", "VIMNMX")),
)
_CLASS_OF = {op: name for name, ops in CLASSES for op in ops}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.\w]*)\s*([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def disassemble(lib: Path) -> Dict[str, List[tuple]]:
    """``parse_sass`` of `cuobjdump -sass lib`."""
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    return parse_sass(subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                                     text=True, check=True).stdout)


def parse_sass(text: str) -> Dict[str, List[tuple]]:
    """Per kernel (demangled name): its instructions as (address, opcode,
    modifiers, operands), a branch's operands resolved to its target
    address."""
    funcs: Dict[str, List[tuple]] = {}
    labels: Dict[str, Dict[str, int]] = {}
    name, pending = None, []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            name = _build.demangle(m.group(1))
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            funcs[name].append((addr, m.group(3), m.group(4), m.group(5).strip()))
    for name, insns in funcs.items():
        for k, (addr, op, mods, operands) in enumerate(insns):
            if op == "BRA":
                t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", operands)
                target = (labels[name].get(t.group(1)) if t and t.group(1)
                          else int(t.group(2), 16) if t else None)
                insns[k] = (addr, op, mods, target)
    return funcs


def classify(op: str, mods: str) -> str:
    if op in ("I2F", "I2FP") and ".RP" in mods:
        return "int_div"  # the reciprocal estimate that opens a run-time divide
    return _CLASS_OF.get(op, "other")


def loops(insns) -> List[tuple]:
    """(start, end) index ranges of backward branches' bodies."""
    index = {a: k for k, (a, *_) in enumerate(insns)}
    out = []
    for k, (addr, op, _, target) in enumerate(insns):
        if op == "BRA" and isinstance(target, int) and target <= addr and target in index:
            out.append((index[target], k))
    return out


def loads_per_sample(name: str, body) -> int:
    """Global loads one sample of the loop `body` issues: its tap words
    (C = 3 reads 4 words a sample, C = 1 one); for the backward
    (``window_grad_kernel``) also its C cotangent floats where the loop
    reads no shared memory, as the one-warp-a-window design reads its
    cotangent from global memory (the staged design reads it with LDS)."""
    rgb = re.search(r"<3,", name) is not None
    loads = 4 if rgb else 1
    if name.startswith("window_grad_kernel") and not any(op == "LDS" for _, op, _, _ in body):
        loads += 3 if rgb else 1
    return loads


def sampling_loop(name: str, insns) -> Optional[dict]:
    """The innermost loop with global loads, its class counts and the
    counts per sample (samples from the loop's global loads,
    ``loads_per_sample`` a sample)."""
    best = None
    for a, b in loops(insns):
        body = insns[a:b + 1]
        n_ldg = sum(op == "LDG" for _, op, _, _ in body)
        if n_ldg == 0:
            continue
        if best is None or (b - a) < (best[1] - best[0]):
            best = (a, b, n_ldg)
    if best is None:
        return None
    a, b, n_ldg = best
    counts = collections.Counter({k: 0 for k in ("int_div", "other", *dict(CLASSES))})
    counts.update(classify(op, mods) for _, op, mods, _ in insns[a:b + 1])
    body = insns[a:b + 1]
    loads = loads_per_sample(name, body)
    samples = n_ldg / loads
    rec = {"instructions": b - a + 1, "samples_per_pass": samples, "loads_per_sample": loads,
           "counts": dict(counts),
           "per_sample": {k: v / samples for k, v in sorted(counts.items())},
           "per_sample_total": (b - a + 1) / samples,
           "opcodes": dict(collections.Counter(op + mods for _, op, mods, _ in
                                               body).most_common(40))}
    ops = [op for _, op, _, _ in body]
    first = ops.index("LDG")
    if "SHFL" in ops[first:]:
        # a loop that walks its samples and then reduces them by shuffles
        # (the backward's staged design, whose loop is a whole tile): the
        # walk alone, from its first global load to its first shuffle
        rec["walk_per_sample_total"] = (ops.index("SHFL", first) - first) / samples
    return rec


PROBE_SRC = r"""
#include <cuda_runtime.h>
// chains of one instruction kind, 8 independent chains a thread
template <int OP>
__global__ void probe(int* out, int n, int seed) {
  int a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = seed + threadIdx.x * 8 + k;
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float f = __int_as_float(a[k]);
      if (OP == 0) a[k] = __float_as_int(__fadd_rn(f, 1.0f));
      if (OP == 1) a[k] = __float_as_int(__int2float_rn(a[k]));
      if (OP == 2) a[k] = __float2int_rz(f);
      if (OP == 3) a[k] = __byte_perm(a[k], 0x4B000000, 0x7441);
      if (OP == 4) a[k] = __float_as_int(fminf(fmaxf(f, 0.0f), 100.0f));
      if (OP == 5) a[k] = __float_as_int((float)((a[k] >> 8) & 0xFF));
      if (OP == 6)
        a[k] = __float_as_int(
            __fsub_rn(__int_as_float(__byte_perm(a[k], 0x4B000000, 0x7441)), 8388608.0f));
    }
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int probe_launch(int op, int blocks, int threads, int n, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case 0: probe<0><<<blocks, threads, 0, st>>>(out, n, 1); break;
    case 1: probe<1><<<blocks, threads, 0, st>>>(out, n, 1); break;
    case 2: probe<2><<<blocks, threads, 0, st>>>(out, n, 1); break;
    case 3: probe<3><<<blocks, threads, 0, st>>>(out, n, 1); break;
    case 4: probe<4><<<blocks, threads, 0, st>>>(out, n, 1); break;
    case 5: probe<5><<<blocks, threads, 0, st>>>(out, n, 1); break;
    case 6: probe<6><<<blocks, threads, 0, st>>>(out, n, 1); break;
    default: return 1;
  }
  return (int)cudaGetLastError();
}
"""
PROBES = ("fadd", "i2f", "f2i", "prmt", "fmnmx_pair", "byte_shift_mask_i2f",
          "byte_f32_prmt_fadd")


def throughput(workdir: Path) -> dict:
    """Rates of the probe chains on the card: per probe its instructions
    a chain step (from its SASS), instructions per ns over the whole
    card, and that rate over FADD's."""
    import torch

    src = workdir / "probe.cu"
    lib = workdir / "libprobe.so"
    src.write_text(PROBE_SRC)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    sass = disassemble(lib)
    so = ctypes.CDLL(str(lib))
    so.probe_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    props = torch.cuda.get_device_properties(0)
    blocks, threads, n = props.multi_processor_count * 8, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rec = {}
    for op, name in enumerate(PROBES):
        body = [(o, m) for _, o, m, _ in (sass.get(f"probe<{op}>") or [])]
        kinds = collections.Counter(o + m for o, m in body)
        for _ in range(2):  # warm-up
            assert so.probe_launch(op, blocks, threads, n, out.data_ptr(), stream) == 0
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            so.probe_launch(op, blocks, threads, n, out.data_ptr(), stream)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / 5
        steps = blocks * threads * n * 8
        rec[name] = {"ms": ms, "chain_steps_per_ns": steps / (ms * 1e6),
                     "sass_opcodes": dict(kinds.most_common(12))}
    base = rec["fadd"]["chain_steps_per_ns"]
    for r in rec.values():
        r["steps_rate_over_fadd"] = r["chain_steps_per_ns"] / base
    return {"device": torch.cuda.get_device_name(0), "sms": props.multi_processor_count,
            "blocks": blocks, "threads": threads, "steps_per_thread": n * 8, "probes": rec}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.sass_mix",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--lib", type=Path, help="default: this checkout's library")
    ap.add_argument("--throughput", action="store_true", help="time the probe chains")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    lib = args.lib or _build.build()
    funcs = disassemble(lib)
    rec = {"lib": str(lib), "kernels": {n: sampling_loop(n, insns)
                                        for n, insns in sorted(funcs.items())}}
    if args.throughput:
        _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as td:
            rec["throughput"] = throughput(Path(td))
    text = json.dumps(rec)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
