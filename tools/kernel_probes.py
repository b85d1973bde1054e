"""Probe design choices of the port's kernels on an H100.

Each probe builds variants of one kernel from the repo's source, each with
one change, swaps each in for the wrapper's library, and holds it against
the plain version on the same inputs:

* ``redux``: the JSQ router's shared-memory variant without the
  ``__syncwarp()`` before its ``redux.sync`` warp max, at r = 16, p = 200
  (its server loops diverge there); the register variant with one more
  ``__syncwarp()`` a step, timed against the kernel as it is.  Prints the
  SASS before every REDUX of both builds (is the warp converged there?).
* ``d8``: both attention kernels in bfloat16 at D = 8 without their
  second P V product on P - bf16(P), at every D = 8 shape of
  tests/test_torch_gpu.py (its seeds), beside the kernels as they are.
* ``scan``: the segmented (max,+) scan with 4 or 8 items a lane, one warp
  a row or a persistent grid (as many blocks as fit on the card at once,
  each warp walking rows), timed in turns at the replicated path's
  server scan, (6400, 4096) float32 and float64 with (64, 4096) flags,
  out_a only and both outputs.
* ``fleet``: the fleet scan fetching its inputs 1, 2 or 4 tiles ahead,
  and with 8, 16 or 32 controller steps a branch-free batch, timed in
  turns at (64, 4096), r = 4, float32: the mask alone, the policy alone
  and both, at a decision every 20 s and at 17b's rate.
* ``bag``: the embedding bag with 12, 16 or 20 bytes of a row a lane or
  one unit a lane (at D = 10 bf16: 2, 2, 1 or 5 lanes a bag), without
  its evict-first hints, and with a division for every count, timed in
  turns at xDeepFM's serve_p99 and serve_bulk batches (D = 10, int32 and
  int64 ids, and the wide D = 1), at serve_bulk with every id folded
  onto 2^16 rows (all in L2) and with nothing gathered (an all-false
  mask), and at D = 16 and 128 (AutoInt's width and a wide one;
  serve_bulk's first 4096 samples' ids folded onto 2^20 rows).

The scan and bag variants are held against the plain version at every
case before they are timed, the fleet variants on one case.  Run from the repo's root on a machine with a
card and nvcc: ``python3 tools/kernel_probes.py [redux] [d8] [scan]
[bag] [fleet]`` (all by default).  The variants are built under a temporary
directory; full SASS listings go to ``src/repro_torch/kernels/_build/
probes/`` (beside the built libraries).
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

sys.path.insert(0, str(ROOT))
from chip_smoke import _device_ms  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
OUT = KERNELS / "_build" / "probes"


def variant(tmp: pathlib.Path, lib: _cuda.CudaLibrary, name: str,
            edits: list[tuple[str, str]]) -> _cuda.CudaLibrary:
    """``lib``'s source and its package's own headers with each (old,
    new) replaced, built beside a copy of the shared headers so that its
    includes resolve."""
    own = [h for h in lib.headers if h.parent == lib.source.parent]
    texts = {f: f.read_text() for f in (lib.source, *own)}
    for old, new in edits:
        if not any(old in t for t in texts.values()):
            raise AssertionError(f"{name}: {old!r} not in "
                                 f"{[f.name for f in texts]}")
        texts = {f: t.replace(old, new) for f, t in texts.items()}
    shared = tmp / "kernels" / "csrc"
    if not shared.exists():
        shutil.copytree(KERNELS / "csrc", shared)
    src = tmp / "kernels" / name / "csrc" / lib.source.name
    src.parent.mkdir(parents=True, exist_ok=True)
    for f, t in texts.items():
        (src.parent / f.name).write_text(t)
    headers = [src.parent / h.name if h in own else h for h in lib.headers]
    out = _cuda.CudaLibrary(src, lib.entries, headers=headers)
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


def _ptxas_lines(lib: _cuda.CudaLibrary, what: str, only: str = "") -> None:
    """Registers and spills of each kernel instantiation whose demangled
    name holds ``only``, one line each."""
    name = "?"
    for line in lib.build_log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)],
                                  capture_output=True, text=True
                                  ).stdout.strip() or m.group(1)
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
        if only not in name:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(f"      {what}: {name[5:75]} {m.group(1)} registers")
        if "spill" in line and not re.search(r"\b0 bytes spill stores",
                                             line):
            print(f"      {what}: {name[5:75]} {line.strip()[:60]}")


def _in_turns(variants: dict, time_one, turns: int = 3) -> None:
    """Time each variant ``turns`` times, in turns; print all and the
    least."""
    times = {tag: [] for tag in variants}
    for _ in range(turns):
        for tag, lib in variants.items():
            times[tag].append(time_one(lib))
    for tag, t in times.items():
        print(f"    {tag:28s} " + " / ".join(f"{x:.4f}" for x in t)
              + f" ms (least {min(t):.4f})")


SCAN_GRID = ("  const int64_t blocks = (rows + kRowWarps - 1) / kRowWarps;"
             "  // warp a row\n")
SCAN_PERSISTENT = (
    "  int dev = 0, sms = 0, per_sm = 0;\n"
    "  cudaGetDevice(&dev);\n"
    "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
    "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
    "      &per_sm, maxplus_segment_scan_kernel<T, kWithB>, kRowThreads, 0);\n"
    "  const int64_t want = (rows + kRowWarps - 1) / kRowWarps;\n"
    "  const int64_t fit = static_cast<int64_t>(sms) * per_sm;\n"
    "  const int64_t blocks = want < fit ? want : fit;  // persistent\n")
SCAN_ITEMS = ("constexpr int kLaneItems = 4;",
              "constexpr int kLaneItems = 8;")


def probe_scan(tmp: pathlib.Path) -> None:
    from repro_torch.kernels.maxplus_scan import kernel, ops
    base = kernel.SEGMENT_LIB
    base.load()
    variants = {
        "4 items, warp a row": base,
        "8 items, warp a row": variant(tmp, base, "seg_i8", [SCAN_ITEMS]),
        "4 items, persistent": variant(tmp, base, "seg_p",
                                       [(SCAN_GRID, SCAN_PERSISTENT)]),
        "8 items, persistent": variant(tmp, base, "seg_i8p",
                                       [SCAN_ITEMS,
                                        (SCAN_GRID, SCAN_PERSISTENT)])}
    print("== scan: the segmented (max,+) scan's variants")
    for tag, lib in variants.items():
        _ptxas_lines(lib, tag)
    g = torch.Generator(device="cuda").manual_seed(17)
    cases = [((6400, 4096), (64, 4096)), ((37, 1000), (37, 1000)),
             ((15, 777), (3, 777)), ((4, 4096), (1, 4096))]
    for (shape, fshape), dtype in ((c, d) for c in cases
                                   for d in (torch.float32, torch.float64)):
        arr = torch.empty(shape, dtype=dtype, device="cuda").exponential_(
            generator=g).cumsum(-1)
        b = torch.empty(shape, dtype=dtype, device="cuda").exponential_(
            generator=g)
        a = arr + b
        f = (torch.rand(fshape, device="cuda", generator=g) < 0.05
             ).to(torch.uint8)
        rpf = shape[0] // fshape[0]
        pa, pb = ops.maxplus_segment_scan(
            a, b, f.repeat_interleave(rpf, 0), impl="torch")
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        for tag, lib in variants.items():
            kernel.SEGMENT_LIB = lib
            ka, kb = kernel.maxplus_segment_scan_cuda(a, b, f)
            oa, none = kernel.maxplus_segment_scan_cuda(a, b, f,
                                                        with_b=False)
            torch.cuda.synchronize()
            err = max(float(((x - y).abs() / y.abs().clamp_min(1e-30)).max())
                      for x, y in ((ka, pa), (kb, pb)))
            if not (err <= rtol and torch.equal(oa, ka) and none is None):
                raise AssertionError(f"{tag} at {shape} {dtype}: rel err "
                                     f"{err}, out_a-only equal "
                                     f"{torch.equal(oa, ka)}")
        kernel.SEGMENT_LIB = base
    print("  every variant within rtol of the plain version, out_a only "
          "bitwise equal to the two-output out_a (4 shapes x 2 dtypes)")
    a, b = (torch.rand((6400, 4096), device="cuda", generator=g) + 0.5
            for _ in range(2))
    f = (torch.rand((64, 4096), device="cuda", generator=g) < 0.05
         ).to(torch.uint8)
    for dtype in (torch.float32, torch.float64):
        x, y = a.to(dtype), b.to(dtype)
        for with_b in (False, True):
            moved = x.numel() * x.element_size() * (4 if with_b else 3) \
                + f.numel()
            print(f"  (6400, 4096) {str(dtype)[6:]}, flags (64, 4096), "
                  f"{'both outputs' if with_b else 'out_a only'}: bound "
                  f"{moved / 3.35e12 * 1e3:.4f} ms ({moved / 1e6:.1f} MB)")

            def one(lib):
                kernel.SEGMENT_LIB = lib
                return _device_ms(lambda: kernel.maxplus_segment_scan_cuda(
                    x, y, f, with_b=with_b))
            _in_turns(variants, one)
    kernel.SEGMENT_LIB = base


BAG_PER_LANE = "return w == 2 ? 1 : (w == 4 ? 3 : 16 / w);\n}"
BAG_STORE_PLAIN = [("__stcs(", "st_plain("),
                   ("// The output is written once",
                    "template <typename P, typename V>\n"
                    "__device__ __forceinline__ void st_plain(P* p, V v) "
                    "{ *p = v; }\n\n// The output is written once")]
BAG_NO_HINTS = [("__ldcs(", "__ldg(")] + BAG_STORE_PLAIN
BAG_DIVIDE = ("v[e] = pow2 ? x * inv : x / static_cast<float>(c);",
              "v[e] = x / static_cast<float>(c);")


def probe_bag(tmp: pathlib.Path) -> None:
    import numpy as np
    from repro_torch.configs import xdeepfm
    from repro_torch.data.recsys_data import ctr_batch
    from repro_torch.kernels.embedding_bag import kernel, ref
    from repro_torch.models import recsys as RS
    base = kernel.LIB
    base.load()

    def per_lane(rule):
        return [(BAG_PER_LANE, f"return {rule};\n}}")]

    variants = {
        "12 B a lane (as is)": base,
        "16 B a lane": variant(tmp, base, "bag_16",
                               per_lane("w == 2 ? 1 : 16 / w")),
        "20 B a lane": variant(tmp, base, "bag_20",
                               per_lane("w == 2 ? 1 : (w == 4 ? 5 : 16 / w)")),
        "one unit a lane": variant(tmp, base, "bag_1", per_lane("1")),
        "12 B a lane, no hints": variant(tmp, base, "bag_plain",
                                         BAG_NO_HINTS),
        "12 B a lane, divide": variant(tmp, base, "bag_div", [BAG_DIVIDE])}
    print("== bag: the embedding bag's variants: bytes of a row a lane (at "
          "D = 10 bf16, 4-byte units: 12 B = 2 lanes a bag as 3 + 2 units, "
          "16 B = 2 as 4 + 1, 20 B = 1, one unit = 5); no evict-first "
          "hints on the mask, ids and output; a division where the count "
          "is a power of two")
    for tag, lib in variants.items():
        _ptxas_lines(lib, tag, only="bfloat16, int, 4, true")
    cfg = xdeepfm.FULL
    g = torch.Generator(device="cuda").manual_seed(18)
    rows = RS.padded_rows(cfg.total_rows)
    table = (0.01 * torch.randn((rows, cfg.embed_dim), generator=g,
                                device="cuda")).to(torch.bfloat16)
    wide = (0.01 * torch.randn((rows, 1), generator=g, device="cuda")
            ).to(torch.bfloat16)
    batches = {}
    for name, bsz, step in (("serve_p99", 512, 0), ("serve_bulk", 262_144,
                                                    4)):
        ids, mask, _ = ctr_batch(cfg, bsz, step=step, seed=0)
        batches[name] = (torch.from_numpy(ids.astype(np.int32)).cuda(),
                         torch.from_numpy(mask).cuda())
    b_ids, b_mask = batches["serve_bulk"]
    small = (b_ids[:4096] % (1 << 20), b_mask[:4096])
    cases = [("D=10 serve_p99", table, *batches["serve_p99"]),
             ("D=10 serve_bulk", table, b_ids, b_mask),
             ("D=10 serve_bulk int64 ids", table, b_ids.long(), b_mask),
             ("D=1 (wide) serve_p99", wide, *batches["serve_p99"]),
             ("D=1 (wide) serve_bulk", wide, b_ids, b_mask)]
    # where the time goes at D = 10: the same bags with every id folded
    # onto 2^16 rows (1.3 MB, all in L2), and with nothing gathered
    cases += [("D=10 serve_bulk, ids on 2^16 rows", table,
               b_ids % (1 << 16), b_mask),
              ("D=10 serve_bulk, mask all false", table, b_ids,
               torch.zeros_like(b_mask))]
    for d in (16, 128):
        t = (0.01 * torch.randn((1 << 20, d), generator=g, device="cuda")
             ).to(torch.bfloat16)
        cases.append((f"D={d}, 4096 x 39 bags, 2^20 rows", t, *small))
    for what, tab, ids, mask in cases:
        expect = ref.embedding_bag_masked(tab.float(), ids, mask)
        for tag, lib in variants.items():
            kernel.LIB = lib
            out = kernel.embedding_bag_cuda(tab, ids, mask)
            torch.cuda.synchronize()
            diff = (out.float() - expect).norm(dim=-1)
            den = expect.norm(dim=-1)
            err = float((diff / den.masked_fill(den == 0, 1.0)).max())
            if not err <= 1e-2 or bool((diff[den == 0] > 0).any()):
                raise AssertionError(f"{tag}, {what}: row err {err}")
        kernel.LIB = base
        plan = kernel.bag_plan(tab, ids, mask)
        print(f"  {what}: {plan}; every variant within 1e-2 (row "
              f"relative L2); device ms a call:")

        def one(lib):
            kernel.LIB = lib
            return _device_ms(lambda: kernel.embedding_bag_cuda(tab, ids,
                                                                 mask))
        _in_turns(variants, one)
    kernel.LIB = base


FLEET_AHEAD = "constexpr int kAhead = 2;"
FLEET_BATCH = "constexpr int kBatch = 16;"


def probe_fleet(tmp: pathlib.Path) -> None:
    from chip_smoke import R, SIM17_BIN_S, _fleet_case
    from repro_torch.kernels.fleet_scan import kernel, ops
    base = kernel.LIB
    base.load()
    variants = {
        "as is (2 tiles ahead, batch 16)": base,
        "1 tile ahead": variant(tmp, base, "fleet_a1",
                                [(FLEET_AHEAD, "constexpr int kAhead = 1;")]),
        "4 tiles ahead": variant(tmp, base, "fleet_a4",
                                 [(FLEET_AHEAD,
                                   "constexpr int kAhead = 4;")]),
        "batch 8": variant(tmp, base, "fleet_b8",
                           [(FLEET_BATCH, "constexpr int kBatch = 8;")]),
        "batch 32": variant(tmp, base, "fleet_b32",
                            [(FLEET_BATCH, "constexpr int kBatch = 32;")])}
    print("== fleet: the fleet scan's variants")
    for tag, lib in variants.items():
        _ptxas_lines(lib, tag)
    g = torch.Generator(device="cuda").manual_seed(20)
    cases = {f"{what}{', 17b rate' if real else ', 20 s'}":
             _fleet_case(R, torch.float32, what, g, real=real)
             for what, real in (("fault", False), ("policy", True),
                                ("policy", False), ("both", False),
                                ("both", True))}
    gaps, kw = cases["both, 20 s"]
    plain = ops.fleet_scan(gaps, impl="torch", **kw)
    for tag, lib in variants.items():
        kernel.LIB = lib
        got = ops.fleet_scan(gaps, impl="cuda", **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], plain[0]) and torch.equal(got[1],
                                                                plain[1])):
            raise AssertionError(f"fleet variant {tag} disagrees with the "
                                 "plain loop")
    kernel.LIB = base
    print(f"  every variant equals the plain loop (64 x 4096, r = {R}, "
          f"both; decision interval 20 s; 17b's is {SIM17_BIN_S:.0f} s)")
    for what, (gaps, kw) in cases.items():
        print(f"  {what}: device ms a call")

        def one(lib):
            kernel.LIB = lib
            return _device_ms(lambda: ops.fleet_scan(gaps, impl="cuda",
                                                     **kw), n=20)
        _in_turns(variants, one)
    kernel.LIB = base


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    which = argv or ["redux", "d8", "scan", "bag", "fleet"]
    probes = {"redux": probe_redux, "d8": probe_d8, "scan": probe_scan,
              "bag": probe_bag, "fleet": probe_fleet}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        for name in which:
            probes[name](pathlib.Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
