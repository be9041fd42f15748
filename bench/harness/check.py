"""The comparison that decides ``correct``.

``sequence`` (the limits' ``"method"``, the default): once the window
has closed and the program's state is freed, a sample
of the requests the window finished, drawn from the seed and always
holding the longest of them, goes to the plain float32 reference
(``bench/reference/model.py``): each prompt followed by its served
tokens, run whole from the first token.  At each served token the gap
by which the reference's logit of that token lies below the reference's
best logit is read; the widest gap over the sample is compared with the
cell's limit (``bench/limits/<cell>.json``).  Served tokens are greedy,
so a sound program's gaps are rounding; a wrong token, a wrong cache
read or a skipped layer shows as a gap of the size of the logits'
spread.

``replay`` (an MoE configuration, whose routes and drops depend on every
row of a step): :func:`replay` recomputes served steps from the KV
cache they ran on, and reads the gap of each emitted token and the error
of the keys and values the program wrote.  The cache it runs on is
itself checked where it can be without the program's routes: at the
layers before the first MoE layer's output (:func:`route_free_layers`)
the keys and values of every row a replayed step wrote, and those of
every position each segment attends to, read through the program's
block tables, must be those that the request's own tokens make
(:func:`context_check`).  A wrong block-table entry, position or token
in one lane shows there as a row error of order 1.

Every served token's ``rank`` is read too: how many vocabulary entries
the reference puts above it.

The control (``control=True``, run by ``bench/tools/readings.py``, not
by the benchmark's runs) puts the reference in float8 in the program's
place: at each position of the same sequences it reads the gap of the
token that the float8 reference puts first, and the keys and values
that the float8 reference makes; :func:`verdict` judges those readings
as it judges the program's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench.harness import weights as weights_lib
from bench.reference import model as ref

SALT = 0xC0FFEE


def sample(requests: Sequence, window, mix: Dict, seed: int) -> List:
    """The requests the check reads: finished inside ``window``, the
    longest (prompt and output) first, then others in an order drawn
    from the seed until the mix's ``check.served_tokens`` are reached or
    ``check.max_requests`` are taken."""
    t0, t1 = window
    fin = [r for r in requests
           if r.done is not None and t0 <= r.done < t1 and r.n_tokens >= 1]
    if not fin:
        return []
    fin.sort(key=lambda r: r.rid)
    want = mix.get("check", {})
    target = int(want.get("served_tokens", 320))
    most = int(want.get("max_requests", 16))
    longest = max(fin, key=lambda r: (len(r.prompt) + r.n_tokens, r.rid))
    out, n = [longest], longest.n_tokens
    rng = np.random.default_rng((int(seed) ^ SALT) % (2 ** 63))
    for i in rng.permutation(len(fin)):
        if n >= target or len(out) >= most:
            break
        r = fin[int(i)]
        if r is longest:
            continue
        out.append(r)
        n += r.n_tokens
    return out


def gaps_of(cfg: Dict, params: Dict, reqs: Sequence, *, device,
            control: bool = False) -> Dict[str, np.ndarray]:
    """Per served token, the reference's gap (and the control's)."""
    seqs, rows, served = [], [], []
    for r in reqs:
        p = np.asarray(r.prompt, np.int64)
        t = np.asarray(r.tokens, np.int64)
        seqs.append(torch.from_numpy(np.concatenate([p, t[:-1]])))
        rows.append(torch.arange(len(p) - 1, len(p) - 1 + len(t)))
        served.append(torch.from_numpy(t))

    def layer(l):
        return weights_lib.layer(params, l)

    best = ref.logits(cfg, layer, params, seqs, rows, device=device)
    out = _gap_rank(best, [s.to(lg.device) for lg, s in zip(best, served)])
    if control:
        low = ref.logits(cfg, layer, params, seqs, rows, quant="fp8",
                         device=device)
        got = _gap_rank(best, [lw.argmax(dim=-1) for lw in low])
        out.update({"control_" + k: v for k, v in got.items()})
    return out


def _gap_rank(best: Sequence[torch.Tensor],
              picks: Sequence[torch.Tensor]) -> Dict[str, np.ndarray]:
    """For each row of each logits block of ``best`` and the token
    ``picks`` chose there: its gap below the best logit, and its rank
    (how many entries lie strictly above it)."""
    gaps, ranks = [], []
    for lg, t in zip(best, picks):
        mine = lg.gather(1, t[:, None])
        gaps.append((lg.max(dim=-1).values - mine[:, 0]).cpu())
        ranks.append((lg > mine).sum(dim=-1).cpu())
    return {"gap": torch.cat(gaps).numpy(),
            "rank": torch.cat(ranks).numpy().astype(np.float64)}


def sequence_check(cfg: Dict, params: Dict, requests: Sequence, window,
                   mix: Dict, seed: int, *, device,
                   control: bool = False) -> Dict[str, np.ndarray]:
    """The readings of the sequence check (see the module's doc)."""
    reqs = sample(requests, window, mix, seed)
    if not reqs:
        return {"gap": np.zeros(0)}
    return gaps_of(cfg, params, reqs, device=device, control=control)


def _widest(key: str):
    def stat(got: Dict) -> float:
        x = np.concatenate([np.ravel(got[k]) for k in
                            (key, "ctx_" + key) if k in got] or [[]])
        return float(x.max()) if x.size else float("inf")
    return stat


def _mean_gap(got: Dict) -> float:
    g = np.asarray(got["gap"])
    return float(g.mean()) if g.size else float("inf")


# Every number a limits file may name, and the statistic of the readings
# (the program's, or the control's with their prefix taken off).
STATISTICS = {
    "max_gap": _widest("gap"),
    "mean_gap": _mean_gap,
    "max_rank": _widest("rank"),
    # a replay's keys and values at the route-free layers: the rows its
    # steps wrote and (``ctx_``) the rows every live lane attends to
    "max_kv_row_err": _widest("kv_row_err"),
}
LIMIT_KEYS = set(STATISTICS) | {"method", "min_checked_tokens"}


def _judge(got: Dict, limits: Dict, failed: int) -> Dict:
    unknown = set(limits) - LIMIT_KEYS
    if unknown:
        raise ValueError(f"the limits name no statistic {sorted(unknown)}")
    n = int(np.asarray(got["gap"]).size)
    numbers = {k: {"value": stat(got), "limit": float(limits[k])}
               for k, stat in STATISTICS.items() if k in limits}
    numbers["checked_tokens"] = {"value": n,
                                 "limit": int(limits["min_checked_tokens"])}
    numbers["unanswered"] = {"value": int(failed), "limit": 0}
    correct = all(v["value"] <= v["limit"] for k, v in numbers.items()
                  if k != "checked_tokens") and \
        n >= numbers["checked_tokens"]["limit"]
    return {"correct": bool(correct), "numbers": numbers}


def verdict(got: Dict, limits: Dict, failed: int) -> Dict:
    """``correct`` and the numbers compared, each with its limit: those
    of :data:`STATISTICS` that the limits name, how many tokens were
    read, and the requests never answered.  With the control's readings
    in ``got`` (``control_<reading>``), ``"control"`` holds the same
    verdict of the control in the program's place."""
    res = dict(_judge(got, limits, failed), readings=got)
    low = {k[len("control_"):]: v for k, v in got.items()
           if k.startswith("control_")}
    if low:
        res["control"] = _judge(low, limits, failed)
    return res


def describe(numbers: Dict) -> List[str]:
    """One line per number compared: ``name value (limit ...)``."""
    out = []
    for name, v in numbers.items():
        rel = ">=" if name == "checked_tokens" else "<="
        out.append(f"check {name} {v['value']!r} (limit {rel} "
                   f"{v['limit']!r})")
    return out


# ---------------------------------------------------------------------------
# replay: a served step recomputed from the cache it ran on (MoE configs)
# ---------------------------------------------------------------------------
def _pool_rows(pool_l: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Rows ``slots`` of one layer's pool (num_blocks, bs, Hkv, D) as
    float32 (n, Hkv, D)."""
    flat = pool_l.reshape(-1, pool_l.shape[-2], pool_l.shape[-1])
    return flat[slots.long()].to(torch.float32)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over all of a layer's rows."""
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _row_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest over rows of each row's relative error."""
    if not got.shape[0]:
        return 0.0
    num = torch.linalg.vector_norm((got - want).flatten(1), dim=1)
    den = torch.linalg.vector_norm(want.flatten(1), dim=1)
    return float(torch.max(num / den.clamp_min(1e-30)))


def route_free_layers(cfg: Dict) -> int:
    """How many leading layers' keys and values the request's tokens
    alone decide: all layers of a dense model; of an MoE model, those up
    to the first MoE layer, whose output the next layer's keys take."""
    if not cfg.get("n_routed_experts"):
        return int(cfg["num_hidden_layers"])
    return int(cfg.get("first_k_dense_replace", 0)) + 1


def _slots(tables: torch.Tensor, lane: int, p: torch.Tensor,
           bs: int) -> torch.Tensor:
    table = tables[lane].long()
    return table[p // bs] * bs + p % bs


def replay(cfg: Dict, params: Dict, engine, step, *, device,
           control: bool = False) -> Dict[str, np.ndarray]:
    """Recompute ``step`` (a ``drive.StepRec`` with ``detail``, the last
    step ``engine`` ran) with the reference, from the keys and values the
    engine's cache held for the positions before each segment.  Returns
    the gap and rank of every emitted token, per layer the relative
    error of the keys and values the engine wrote for the step's rows,
    and at the route-free layers each layer's widest row error (and, with
    ``control``, the float8 reference's readings in the engine's
    place)."""
    cache = engine.cache
    kpool, vpool = cache["scan"]["k"], cache["scan"]["v"]
    bs = kpool.shape[2]
    tables = cache["block_tables"]
    n_group = int(cache["token_pos"].shape[0])
    w = int(cfg.get("sliding_window") or 0)
    free = route_free_layers(cfg)
    toks, pos, segs, ctx_slots, rows, want = [], [], [], [], [], []
    r0 = 0
    for d in step.detail:
        seg = d.fed + d.drafts
        n = len(seg)
        toks += seg
        pos += list(range(d.start, d.start + n))
        segs.append((r0, n))
        c0 = max(0, d.start - w + 1) if w else 0
        p = torch.arange(c0, d.start, device=tables.device)
        ctx_slots.append(_slots(tables, d.lane, p, bs))
        base = len(d.fed)
        for i, t in enumerate(d.emitted):
            rows.append(r0 + base - 1 + i)
            want.append(t)
        r0 += n
    n_rows = r0
    fresh = sum(1 for d in step.detail if d.start == 0)
    own = cache["slot_mapping"][:n_rows]

    def context(l, i):
        return (_pool_rows(kpool[l], ctx_slots[i]),
                _pool_rows(vpool[l], ctx_slots[i]))

    def run(quant, on_kv):
        return ref.step_logits(
            cfg, lambda l: weights_lib.layer(params, l), params,
            torch.tensor(toks), torch.tensor(pos), segs, context, n_group,
            torch.tensor(rows, dtype=torch.long), quant=quant,
            device=device, on_kv=on_kv)

    kv_ref: Dict[int, tuple] = {}
    kv_err, kv_row = [], []

    def seen(l, k, v):
        if control and l < free:
            kv_ref[l] = (k.clone(), v.clone())
        for pool, x in ((kpool, k), (vpool, v)):
            got = _pool_rows(pool[l], own)
            kv_err.append(_rel(got, x))
            if l < free:
                kv_row.append(_row_max(got, x))

    best = run(None, seen)
    target = torch.tensor(want, device=best.device, dtype=torch.long)
    out = _gap_rank([best], [target])
    out.update({"kv_err": np.asarray(kv_err),
                "kv_row_err": np.asarray(kv_row),
                "fresh_segments": np.asarray([fresh])})
    if control:
        crow = []

        def seen_low(l, k, v):
            if l < free:
                for x, y in zip((k, v), kv_ref[l]):
                    crow.append(_row_max(x, y))

        low = run("fp8", seen_low)
        got = _gap_rank([best], [low.argmax(dim=-1)])
        out.update({"control_" + k: v for k, v in got.items()})
        out["control_kv_row_err"] = np.asarray(crow)
    return out


def context_check(cfg: Dict, params: Dict, engine, history, *, device,
                  control: bool = False,
                  group: int = 8) -> Dict[str, np.ndarray]:
    """The keys and values that every live lane of ``engine`` holds,
    read from its pools through its block manager's tables (which also
    cover a prefix taken from the cache at admission) for the positions its
    next query attends to, against those that the request's tokens
    (``history(rid)``: prompt then emitted tokens) make in the
    reference, run whole from the first token, at the route-free layers.
    Returns per lane, layer and K/V the widest row error
    (``ctx_kv_row_err``; and the float8 reference's against the float32
    one under ``control_ctx_kv_row_err``).  Lanes go to the reference
    ``group`` at a time."""
    cache = engine.cache
    kpool, vpool = cache["scan"]["k"], cache["scan"]["v"]
    bs = kpool.shape[2]
    w = int(cfg.get("sliding_window") or 0)
    free = route_free_layers(cfg)
    live = [(r.request_id, r.cursor)
            for r in engine.scheduler.running if r.cursor > 0]
    err, cerr = [], []
    for g0 in range(0, len(live), group):
        part = live[g0:g0 + group]
        seqs = [torch.as_tensor(np.asarray(history(rid)[:n], np.int64))
                for rid, n in part]

        def kv(quant):
            return ref.keys_values(
                cfg, lambda l: weights_lib.layer(params, l), params, seqs,
                free, quant=quant, device=device)

        want = kv(None)
        low = kv("fp8") if control else None
        for i, (rid, n) in enumerate(part):
            table = torch.as_tensor(engine.kv.padded_table(rid),
                                    device=kpool.device).long()
            c0 = max(0, n - w + 1) if w else 0
            p = torch.arange(c0, n, device=kpool.device)
            slots = table[p // bs] * bs + p % bs
            for l in range(free):
                for j, pool in enumerate((kpool, vpool)):
                    ref_rows = want[i][l][j][c0:]
                    err.append(_row_max(_pool_rows(pool[l], slots),
                                        ref_rows))
                    if low is not None:
                        cerr.append(_row_max(low[i][l][j][c0:], ref_rows))
        del want, low
    out = {"ctx_kv_row_err": np.asarray(err)}
    if control:
        out["control_ctx_kv_row_err"] = np.asarray(cerr)
    return out
