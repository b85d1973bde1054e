"""Host cost of reaching a hand-written kernel through its custom operator.

The four kernels on the dry run's paths are custom operators
(``repro_torch::flash_attention``, ``decode_attention``,
``embedding_bag``, ``cin_layer``), so that a trace on fake tensors and
``FlopCounterMode`` see them.  This script times, on the card, back-to-
back calls of `decode_attention_cuda` through the operator and of the
function the operator wraps (``_init_fn``), at one decode layer of
Qwen3-1.7B (B = 1, 16 query heads over 8 kv heads, D = 128, bfloat16,
4,096 cached positions): the host's seconds a call, the loop ended by
one synchronisation.  Rounds alternate operator, body, body, operator;
the median round of each is printed, and the difference.

Run (needs a CUDA card):  python3 tools/op_dispatch_overhead.py
"""

import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

CALLS = 2000
ROUNDS = 6


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _per_call_us(fn, args) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e6


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("op_dispatch_overhead: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.decode_attention import kernel
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 1, 16, 128), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((1, 4096, 8, 128), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    args = (q, k, v, 4095)
    op = kernel.decode_attention_cuda
    body = op._init_fn
    if not torch.equal(op(*args), body(*args)):
        raise AssertionError("the operator and its body disagree")
    for fn in (op, body):                      # warm both paths
        _per_call_us(fn, args)
    times = {"operator": [], "body": []}
    for _ in range(ROUNDS // 2):
        for name in ("operator", "body", "body", "operator"):
            times[name].append(_per_call_us(
                op if name == "operator" else body, args))
    med = {name: statistics.median(t) for name, t in times.items()}
    print(f"decode_attention_cuda, {CALLS} calls a round, {ROUNDS} rounds "
          f"each: through the operator {med['operator']:.2f} us a call, "
          f"the body {med['body']:.2f} us, the operator's dispatch "
          f"{med['operator'] - med['body']:.2f} us [{_card()}]")
    print("rounds (us a call): " + "; ".join(
        f"{name} " + ", ".join(f"{t:.2f}" for t in ts)
        for name, ts in times.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
