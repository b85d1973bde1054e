"""Probe two design choices of the port's kernels on an H100.

Each probe builds a variant of one kernel from the repo's source with one
change, swaps it in for the wrapper's library, and holds it against the
plain version on the same inputs:

* ``redux``: the JSQ router's shared-memory variant without the
  ``__syncwarp()`` before its ``redux.sync`` warp max, at r = 16, p = 200
  (its server loops diverge there); the register variant with one more
  ``__syncwarp()`` a step, timed against the kernel as it is.  Prints the
  SASS before every REDUX of both builds (is the warp converged there?).
* ``d8``: both attention kernels in bfloat16 at D = 8 without their
  second P V product on P - bf16(P), at every D = 8 shape of
  tests/test_torch_gpu.py (its seeds), beside the kernels as they are.

Run from the repo's root on a machine with a card and nvcc:
``python3 tools/kernel_probes.py [redux] [d8]`` (both by default).  The
variants are built under a temporary directory; full SASS listings go to
``src/repro_torch/kernels/_build/probes/`` (beside the built libraries).
"""

from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _cuda  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
OUT = KERNELS / "_build" / "probes"


def variant(tmp: pathlib.Path, lib: _cuda.CudaLibrary, name: str,
            edits: list[tuple[str, str]]) -> _cuda.CudaLibrary:
    """``lib``'s source with each (old, new) replaced once, built beside
    a copy of the shared headers so that its includes resolve."""
    text = lib.source.read_text()
    for old, new in edits:
        if text.count(old) < 1:
            raise AssertionError(f"{name}: {old!r} not in {lib.source.name}")
        text = text.replace(old, new)
    shared = tmp / "kernels" / "csrc"
    if not shared.exists():
        shutil.copytree(KERNELS / "csrc", shared)
    src = tmp / "kernels" / name / "csrc" / lib.source.name
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    out = _cuda.CudaLibrary(src, lib.entries)
    out.load()
    return out


def sass_before_redux(lib: _cuda.CudaLibrary, tag: str) -> None:
    """Print, for each function of ``lib`` with a REDUX, the instructions
    that lead to it; the whole listing goes to OUT."""
    so = max(lib.build_dir.glob("*.so"), key=lambda f: f.stat().st_mtime)
    cuobjdump = pathlib.Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{tag}.sass").write_text(sass)
    func, seen = "?", []
    for line in sass.splitlines():
        if "Function :" in line:
            func, seen = line.split("Function :")[1].strip(), []
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m:
            seen.append(re.sub(r"\s+", " ", m.group(1)))
            if "REDUX" in m.group(1):
                print(f"  [{tag}] {func[:70]}:\n      "
                      + "\n      ".join(seen[-10:]))


def jsq_inputs(s, r, p, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand((s, r, p), dtype=dtype, device="cuda", generator=g)
    w[0] = 0.0
    gaps = torch.empty((s, n), dtype=dtype, device="cuda").exponential_(
        generator=g) * 0.3 / r
    svc = torch.empty((s, p, n), dtype=dtype, device="cuda").exponential_(
        generator=g)
    live = (torch.rand((s, n), device="cuda", generator=g) > 0.2).to(dtype)
    return w, gaps, svc, live


def probe_redux(tmp: pathlib.Path) -> None:
    from repro_torch.kernels.jsq_route import kernel, ref
    base = kernel.LIB
    base.load()
    nosync = variant(tmp, base, "jsq_nosync", [
        ("    __syncwarp();\n    m[k] = warp_max(loc);",
         "    m[k] = warp_max(loc);"),
        ("      __syncwarp();\n      const T mx = warp_max(loc);",
         "      const T mx = warp_max(loc);")])
    regsync = variant(tmp, base, "jsq_regsync", [
        ("      const T mx = warp_max(select_at(lmax, best));",
         "      __syncwarp();\n"
         "      const T mx = warp_max(select_at(lmax, best));")])
    print("== redux: SASS before each REDUX")
    sass_before_redux(base, "jsq_as_is")
    sass_before_redux(nosync, "jsq_nosync")
    print("== redux: choices against the plain loop (mismatched / all)")
    shapes = [(6, 16, 200, 70, torch.float32), (64, 16, 200, 4096,
                                                torch.float32),
              (64, 13, 70, 1024, torch.float64), (64, 16, 40, 4096,
                                                  torch.float32),
              (64, 13, 70, 4096, torch.float32), (64, 4, 100, 4096,
                                                  torch.float32)]
    for s, r, p, n, dtype in shapes:
        w, gaps, svc, live = jsq_inputs(s, r, p, n, dtype, r * 1000 + p)
        pc, pw = ref.jsq_route_ref(w, gaps, svc, live)
        plan = kernel.jsq_plan(r, p, w.element_size())
        row = []
        for tag, lib in (("as is", base), ("no sync", nosync),
                         ("reg sync", regsync)):
            kernel.LIB = lib
            kc, kw = kernel.jsq_route_cuda(w, gaps, svc, live)
            torch.cuda.synchronize()
            first = (kc != pc).flatten().nonzero()
            row.append(f"{tag}: {int((kc != pc).sum())}/{kc.numel()}"
                       f"{'' if torch.equal(kw, pw) else ' tracker differs'}"
                       f"{f' (first at {int(first[0])})' if len(first) else ''}")
        kernel.LIB = base
        print(f"  ({s}, r={r}, p={p}, n={n}) {str(dtype)[6:]} "
              f"{'registers' if plan.registers else 'shared'}: "
              + "; ".join(row))
    w, gaps, svc, live = jsq_inputs(64, 4, 100, 4096, torch.float32, 6)
    times = {"as is": [], "reg sync": []}
    for _ in range(3):
        for tag, lib in (("as is", base), ("reg sync", regsync)):
            kernel.LIB = lib
            times[tag].append(_ms(lambda: kernel.jsq_route_cuda(
                w, gaps, svc, live)))
    kernel.LIB = base
    for tag, t in times.items():
        print(f"  (64, 4, 100, 4096) float32 {tag}: "
              + " / ".join(f"{x:.4f}" for x in t)
              + f" ms a chunk = {min(t) * 1e6 / 4096:.1f} ns a step")


def _ms(fn, n=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _worst_row(out, expect):
    return float(((out.float() - expect).norm(dim=-1)
                  / expect.norm(dim=-1)).max())


def _randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)


FLASH = [(1, 1000, 1000, 8, 2, True), (2, 77, 77, 4, 2, True),
         (1, 256, 256, 32, 8, True), (2, 8, 8, 8, 1, True),
         (1, 40, 100, 8, 8, False), (1, 1025, 1025, 16, 2, True),
         (1, 100, 40, 8, 4, True), (2, 300, 300, 12, 4, True),
         (1, 333, 333, 12, 2, True), (1, 200, 200, 24, 2, True),
         (1, 50, 90, 12, 1, False)]
DECODE = [(8, 4096, 32, 8, 2100), (2, 1024, 8, 2, 0), (2, 512, 16, 8, 511),
          (1, 3000, 4, 4, 2999), (3, 100, 8, 1, 57), (2, 700, 12, 4, 333),
          (1, 300, 12, 2, 299), (2, 1000, 24, 2, 999), (1, 40, 16, 1, 5)]


def emulate(q, k, v, n=None, causal=False, round_p=True):
    """The reference's bf16 arithmetic in float32 torch: S = q k^T / sqrt(D)
    over positions < n (decode) or causal, p = exp(S - max), P V with P
    rounded to bf16 (``round_p``) over l from unrounded p, the output
    rounded to bf16.  q (B, Sq, H, D), k, v (B, Sk, KV, D)."""
    g = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    if n is not None:
        kf, vf = kf[:, :, :n], vf[:, :, :n]
    s = qf @ kf.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    ph = p.bfloat16().float() if round_p else p
    return ((ph @ vf) / l).bfloat16().transpose(1, 2)


def probe_d8(tmp: pathlib.Path) -> None:
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    print(f"  allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, float32 "
          f"matmul precision {torch.get_float32_matmul_precision()}")
    f_base, d_base = fk.LIB, dk.LIB
    f_base.load()
    d_base.load()
    f_one = variant(tmp, f_base, "flash_no_rest", [
        ("const bool p_rest = D == 16 && d < 16;",
         "const bool p_rest = false;")])
    d_one = variant(tmp, d_base, "decode_no_rest", [
        ("if (prm.d < 16) {   // D = 8: P - bf16(P) as well",
         "if (false) {")])
    print("== d8: worst row's relative L2 against the plain float32 "
          "version, bfloat16, same inputs per D.  D = 8: kernel as is / "
          "without the P - bf16(P) product / the reference's arithmetic "
          "emulated (P to bf16) / emulated with P unrounded | D = 16: "
          "kernel as is / reference emulated")
    for b, sq, sk, h, kv, causal in FLASH:
        row = []
        for d in (8, 16):
            g = torch.Generator(device="cuda").manual_seed(d + sq)
            q = _randn((b, sq, h, d), g)
            k = _randn((b, sk, kv, d), g)
            v = _randn((b, sk, kv, d), g)
            expect = fops.flash_attention(q.float(), k.float(), v.float(),
                                          causal=causal, impl="torch")
            for lib in ((f_base, f_one) if d == 8 else (f_base,)):
                fk.LIB = lib
                out = fops.flash_attention(q, k, v, causal=causal,
                                           impl="cuda")
                fk.LIB = f_base
                row.append(_worst_row(out, expect))
            for round_p in ((True, False) if d == 8 else (True,)):
                row.append(_worst_row(emulate(q, k, v, causal=causal,
                                              round_p=round_p), expect))
        print(f"  flash ({b}, {sq}, {sk}, {h}, {kv}, causal={causal}): "
              + " / ".join(f"{x:.3e}" for x in row[:4]) + " | "
              + " / ".join(f"{x:.3e}" for x in row[4:]))
    for b, s, h, kv, length in DECODE:
        row = []
        for d in (8, 16):
            g = torch.Generator(device="cuda").manual_seed(d + s + length)
            q = _randn((b, 1, h, d), g)
            k = _randn((b, s, kv, d), g)
            v = _randn((b, s, kv, d), g)
            expect = dops.decode_attention(q.float(), k.float(), v.float(),
                                           length, impl="torch")
            for lib in ((d_base, d_one) if d == 8 else (d_base,)):
                dk.LIB = lib
                out = dops.decode_attention(q, k, v, length, impl="cuda")
                dk.LIB = d_base
                row.append(_worst_row(out, expect))
            for round_p in ((True, False) if d == 8 else (True,)):
                row.append(_worst_row(emulate(q, k, v, n=length + 1,
                                              round_p=round_p), expect))
        print(f"  decode ({b}, {s}, {h}, {kv}, length {length}): "
              + " / ".join(f"{x:.3e}" for x in row[:4]) + " | "
              + " / ".join(f"{x:.3e}" for x in row[4:]))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    which = argv or ["redux", "d8"]
    with tempfile.TemporaryDirectory() as tmp:
        for name in which:
            {"redux": probe_redux, "d8": probe_d8}[name](pathlib.Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
