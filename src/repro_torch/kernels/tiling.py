"""Tile-bounds arithmetic shared by the flash and split-K decode kernels
(counterpart of ``repro.kernels.tiling``, plain Python ints).

The CUDA kernels compute the same bounds on the device; the wrappers,
``chip_smoke.py`` and the tests hold the kernels' visit counters against
these functions, so kernel and analysis cannot drift apart.
"""
from __future__ import annotations

NEG_INF = -1e30
DEFAULT_BQ = 128
DEFAULT_BK = 128
DEFAULT_DECODE_BS = 512


# ---------------------------------------------------------------------------
# Flash (prefill / training) tiles.
# ---------------------------------------------------------------------------
def kv_tile_bounds(qi: int, *, bq: int, bk: int, causal: bool, window: int,
                   kv_len: int) -> tuple[int, int]:
    """Inclusive KV-tile range [lo, hi] that q tile ``qi`` must visit;
    ``hi`` is clamped >= ``lo`` so every q tile visits at least one step."""
    hi_valid = -(-kv_len // bk) - 1            # last non-padded KV tile
    if not causal:
        return 0, hi_valid
    hi = min(hi_valid, ((qi + 1) * bq - 1) // bk)
    lo = 0
    if window > 0:
        lo = max(0, (qi * bq - (window - 1)) // bk)
        hi = max(hi, lo)
    return lo, hi


def kv_visits(s_len: int, *, bq: int, bk: int, causal: bool, window: int,
              kv_len: int) -> list[int]:
    """Per-q-tile visited KV-step counts."""
    return [hi - lo + 1 for lo, hi in
            (kv_tile_bounds(i, bq=bq, bk=bk, causal=causal, window=window,
                            kv_len=kv_len) for i in range(s_len // bq))]


def q_tile_bounds(ki: int, *, bq: int, bk: int, causal: bool, window: int,
                  n_q: int, kv_len: int) -> tuple[int, int]:
    """Inclusive Q-tile range [lo, hi] that KV tile ``ki`` must visit."""
    if not causal:
        return 0, n_q - 1
    lo = min((ki * bk) // bq, n_q - 1)
    hi = n_q - 1
    if window > 0:
        khi = max(min((ki + 1) * bk, kv_len), ki * bk + 1) - 1
        hi = min(hi, (khi + window - 1) // bq)
        hi = max(hi, lo)
    return lo, hi


def q_visits(s_len: int, *, bq: int, bk: int, causal: bool, window: int,
             kv_len: int) -> list[int]:
    """Per-KV-tile visited Q-step counts; fully padded KV tiles count 0."""
    n_q = s_len // bq
    out = []
    for j in range(s_len // bk):
        if j * bk >= kv_len:
            out.append(0)
            continue
        lo, hi = q_tile_bounds(j, bq=bq, bk=bk, causal=causal, window=window,
                               n_q=n_q, kv_len=kv_len)
        out.append(hi - lo + 1)
    return out


def tile_step_counts(s_len: int, *, bq: int = DEFAULT_BQ,
                     bk: int = DEFAULT_BK, causal: bool = True,
                     window: int = 0, kv_len: int | None = None) -> dict:
    """Analytic visited-vs-dense tile-step counts, per attention head."""
    kv_len = s_len if kv_len is None else kv_len
    bq, bk = min(bq, s_len), min(bk, s_len)
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, kv_len=kv_len)
    fwd = sum(kv_visits(s_len, **kw))
    dkv = sum(q_visits(s_len, **kw))
    return {"fwd": fwd, "dq": fwd, "dkv": dkv,
            "dense": (s_len // bq) * (s_len // bk),
            "bq": bq, "bk": bk}


# ---------------------------------------------------------------------------
# Split-K decode grid.
# ---------------------------------------------------------------------------
def resolve_decode_block(s: int, block_s: int) -> int:
    """Largest power-of-two shrink of ``block_s`` that divides S."""
    bs = min(block_s, s)
    while s % bs:
        bs //= 2
    if bs < 1:
        raise ValueError(f"no decode block divides S={s} (block_s={block_s})")
    return bs


def resolve_decode_grid(s: int, *, block_s: int = DEFAULT_DECODE_BS,
                        splits: int = 1) -> tuple[int, int, int, int]:
    """-> (bs, ns, splits_eff, steps_per_split) for a length-S KV cache;
    ``splits`` is clamped to the tile count."""
    bs = resolve_decode_block(s, block_s)
    ns = s // bs
    splits_eff = max(1, min(int(splits), ns))
    spt = -(-ns // splits_eff)
    return bs, ns, splits_eff, spt


def decode_last_live_tile(length: int, *, bs: int, ns: int) -> int:
    """Last KV tile a row with ``length`` valid slots must visit
    (inclusive, clamped to [0, ns-1])."""
    return min(ns - 1, max(0, (length + bs - 1) // bs - 1))


def decode_tile_step_counts(s: int, lengths=None, *,
                            block_s: int = DEFAULT_DECODE_BS,
                            splits: int = 1) -> dict:
    """Analytic twin of the split-K decode kernel's counters:
    ``counts[b][k]`` is the number of KV tiles split ``k`` of row ``b``
    executes (tiles whose start lies below ``lengths[b]``)."""
    bs, ns, splits_eff, spt = resolve_decode_grid(s, block_s=block_s,
                                                  splits=splits)
    lens = [s] if lengths is None else [int(x) for x in lengths]
    counts = []
    for ln in lens:
        if ln <= 0:
            counts.append([0] * splits_eff)
            continue
        hi = decode_last_live_tile(ln, bs=bs, ns=ns)
        counts.append([max(0, min(hi, min((k + 1) * spt, ns) - 1)
                           - k * spt + 1)
                       for k in range(splits_eff)])
    visited = sum(sum(row) for row in counts)
    return {"bs": bs, "ns": ns, "splits": splits_eff, "spt": spt,
            "counts": counts, "visited": visited,
            "dense": len(lens) * ns}


# ---------------------------------------------------------------------------
# How ``csrc/flash_decode.cu`` partitions a split's live span among the
# CTAs of a cluster and their warps (the kernel picks the cluster size).
# ---------------------------------------------------------------------------
DECODE_WARPS = 4          # warps a CTA
DECODE_TOKENS = 32        # tokens a streamed block, one a lane
DECODE_MAX_CLUSTER = 8    # CTAs a cluster, at most
DECODE_MAX_HEADS = 5      # query heads a CTA keeps in registers


def decode_heads_per_block(g: int) -> int:
    """Query heads one CTA takes: the largest divisor of G that is at most
    ``DECODE_MAX_HEADS`` (a larger G runs G / GH head groups)."""
    return max(h for h in range(1, min(g, DECODE_MAX_HEADS) + 1)
               if g % h == 0)


def decode_warp_blocks(n_live: int, cluster: int) -> list[tuple[int, int]]:
    """[first, last) 32-token blocks of a unit's ``n_live`` live tokens that
    each of the cluster's warps streams, in (rank, warp) order."""
    nbt = -(-max(0, n_live) // DECODE_TOKENS)
    nwt = cluster * DECODE_WARPS
    return [(w * nbt // nwt, (w + 1) * nbt // nwt) for w in range(nwt)]
