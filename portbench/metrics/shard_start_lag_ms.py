"""How long the last card waits for its shard's first work: for each
traced dispatch, the time from the first device operation on the first
card to the first on the last card, averaged over the dispatches (layer:
the sharded sweep, `core.sweep._sharded_batch`, whose one host thread
enqueues shard 0's whole chunk loop before shard 1's).  Nothing to read
where a dispatch's operations ran on one card."""

UNIT = "ms"


def read(view):
    firsts = {}                 # dispatch -> {card: first start, us}
    for op in view.ops:
        if op.dispatch is None:
            continue
        cards = firsts.setdefault(op.dispatch, {})
        cards[op.device] = min(cards.get(op.device, op.start_us), op.start_us)
    lags = [c[max(c)] - c[min(c)] for c in firsts.values() if len(c) > 1]
    return 1e-3 * sum(lags) / len(lags) if lags else None
