"""The port's KV wire format, its engine's KV transfer and prefix-cache
persistence, and its ``DisaggregatedEngine``, against the reference's.

* **Wire bytes.**  The same payloads (float32; int8 with float32 scales;
  bfloat16, as ml_dtypes arrays on the reference's side and
  ``torch.bfloat16`` tensors on the port's) serialize to the same bytes and
  checksums in both packages, each package reads the other's bytes, and
  corrupt, truncated, tampered and garbage shipments raise
  ``TransferIntegrityError`` in both.
* **Engines** (gemma-7b and deepseek-moe-16b smoke configs in float32,
  parameters converted from the reference's ``init``; deepseek at capacity
  factor 8.0, where no token is dropped, so that its routes do not depend
  on the batch).  Exported digests equal the reference's exactly and
  payloads within ``ATOL`` (float32 summed in other orders); a shipment or
  a snapshot made by either package imports into the other bit for bit,
  and the next greedy tokens equal that package's own one-engine tokens.
  deepseek's dense first layer travels as the reference's ``"head"`` part,
  which the port splits off its single pool and merges back.
* **The coordinator.**  The port's ``DisaggregatedEngine`` gives its
  one-engine tokens in the three layouts, with and without speculation
  and under pool pressure, and equals the reference coordinator's tokens,
  shipped bytes, dedup counts and simulated clock entries.

The cases marked ``cuda`` repeat the coordinator and the int8 round trip
on the card and skip where there is none:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kv_transfer.py
"""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.serving import (DisaggregatedEngine, KVBlockRecord,
                                 KVShipment, PagedDecodeEngine,
                                 TransferIntegrityError, chain_digest,
                                 payload_checksum)

ROOT = Path(__file__).resolve().parents[1]
# exported float32 KV of one prompt, port against reference: the same
# projections summed in other orders (readings ~1e-6)
ATOL = 1e-5
ENGINE = dict(n_slots=4, cache_len=64)
PROMPT_LEN, MAX_NEW = 37, 6
LAYOUTS = {"default": {}, "per_token": {"tiled": False},
           "rectangular": {"ragged": False}}
ARCHS = ["gemma-7b", "deepseek-moe-16b"]


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(reference api, reference params, port api, port params), both
    float32; deepseek-moe-16b at capacity factor 8.0."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.models.convert import from_reference_params
    jcfg, cfg = (g(arch).smoke_variant() for g in (jax_get_config,
                                                   get_config))
    if cfg.moe is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0)) for c in (jcfg, cfg))
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu", dtype=torch.float32)
    return japi, jparams, build_model(cfg), tparams


def _ref_engine(arch, **kw):
    import jax.numpy as jnp
    from repro.serving import PagedDecodeEngine as JaxPagedEngine
    japi, jparams, _, _ = _models(arch)
    return JaxPagedEngine(japi, jparams, cache_dtype=jnp.float32,
                          compute_dtype=jnp.float32, **{**ENGINE, **kw})


def _port_engine(arch, **kw):
    _, _, api, tparams = _models(arch)
    return PagedDecodeEngine(api, tparams, **{
        "device": "cpu", "cache_dtype": torch.float32, **ENGINE, **kw})


def _prompt(arch):
    vocab = _models(arch)[2].cfg.vocab_size
    return np.random.default_rng(3).integers(0, vocab, PROMPT_LEN).astype(
        np.int32)


def _serve(eng, prompt):
    eng.submit(prompt, MAX_NEW)
    return list(eng.run_until_drained()[0].generated)


@functools.lru_cache(maxsize=None)
def _sources(arch):
    """Each package's engine after serving the prompt (its full blocks
    registered), with the greedy tokens it emitted."""
    ref, port = _ref_engine(arch), _port_engine(arch)
    return ref, _serve(ref, _prompt(arch)), port, _serve(port, _prompt(arch))


def _bits(arr) -> bytes:
    """An array's raw bytes (numpy, ml_dtypes or torch)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.contiguous()
        if arr.dtype == torch.bfloat16:
            arr = arr.view(torch.int16)
        return arr.numpy().tobytes()
    return np.ascontiguousarray(arr).tobytes()


def _assert_pool_holds(engine, shipment):
    """Every carried payload sits bit for bit in the engine's pools."""
    for rec in shipment.blocks:
        if rec.payload is None:
            continue
        got = engine._read_block_payload(engine.kv.digest_block(rec.digest))
        assert set(got) == set(rec.payload)
        for part in rec.payload:
            assert set(got[part]) == set(rec.payload[part])
            for name, arr in rec.payload[part].items():
                assert _bits(got[part][name]) == _bits(arr), (part, name)


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------
def _payloads(kind, rng):
    """(reference payload, port payload) of one block, the same values."""
    shape = (2, 4, 2, 3)
    if kind == "float32":
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        ref = {"scan": {"k": k, "v": v}}
        return ref, {"scan": {n: torch.from_numpy(a.copy())
                              for n, a in ref["scan"].items()}}
    if kind == "int8":
        ref = {"scan": {
            "k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": rng.random(shape[:-1]).astype(np.float32),
            "v_scale": rng.random(shape[:-1]).astype(np.float32)}}
        return ref, {"scan": {n: torch.from_numpy(a.copy())
                              for n, a in ref["scan"].items()}}
    import ml_dtypes
    parts = {"head": (1,) + shape[1:], "scan": shape}
    vals = {p: {n: rng.standard_normal(s).astype(np.float32)
                for n in ("k", "v")} for p, s in parts.items()}
    ref = {p: {n: a.astype(ml_dtypes.bfloat16) for n, a in d.items()}
           for p, d in vals.items()}
    port = {p: {n: torch.from_numpy(a).to(torch.bfloat16)
                for n, a in d.items()} for p, d in vals.items()}
    return ref, port


def _shipments(kind):
    """The same three-block shipment (a partial tail too) built by each
    package from its own payload arrays: (reference, port)."""
    from repro.serving import transfer as rt
    rng = np.random.default_rng(11)
    ref_blocks, port_blocks, parent = [], [], ""
    for _ in range(3):
        tokens = [int(t) for t in rng.integers(0, 100, 4)]
        digest = chain_digest(parent, tokens)
        rp, pp = _payloads(kind, rng)
        ref_blocks.append(rt.KVBlockRecord(digest, parent, tokens, rp,
                                           rt.payload_checksum(rp)))
        port_blocks.append(KVBlockRecord(digest, parent, tokens, pp,
                                         payload_checksum(pp)))
        parent = digest
    return (rt.KVShipment(4, ref_blocks, [7, 8, 9]),
            KVShipment(4, port_blocks, [7, 8, 9]))


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
def test_wire_bytes_match_reference(kind):
    """Identical bytes and checksums; each package reads the other's
    bytes back to the same arrays; dedup-stripped shipments too."""
    pytest.importorskip("jax")
    from repro.serving import transfer as rt
    ref, port = _shipments(kind)
    assert [b.checksum for b in port.blocks] == [b.checksum
                                                 for b in ref.blocks]
    data = ref.serialize()
    assert port.serialize() == data
    back = KVShipment.deserialize(data)
    rback = rt.KVShipment.deserialize(port.serialize())
    for a, b, c in zip(ref.blocks, back.blocks, rback.blocks):
        for part in a.payload:
            for name, arr in a.payload[part].items():
                t = b.payload[part][name]
                assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
                assert str(t.dtype) == f"torch.{arr.dtype}"
                assert tuple(t.shape) == arr.shape
                assert _bits(t) == _bits(arr) == _bits(c.payload[part][name])
    assert back.serialize() == data
    assert (back.partial_tokens, back.block_size) == ([7, 8, 9], 4)
    drop = {ref.blocks[0].digest, ref.blocks[2].digest}
    assert port.drop_payloads(drop).serialize() \
        == ref.drop_payloads(drop).serialize()
    assert (port.n_payloads, port.drop_payloads(drop).n_payloads) == (3, 1)
    assert port.payload_nbytes == sum(
        a.nbytes for b in ref.blocks for p in b.payload.values()
        for a in p.values())


def _corrupt(data: bytes, mode: str, pkg) -> bytes:
    """One corruption of a serialized shipment."""
    if mode == "payload":                   # a flipped KV bit
        out = bytearray(data)
        out[-3] ^= 0x10
        return bytes(out)
    if mode == "truncated":
        return data[:-5]
    if mode == "garbage":
        return b"NOTASHIP" + data[8:]
    ship = pkg.KVShipment.deserialize(data)      # "tampered": a token id
    ship.blocks[1].tokens[0] += 1
    return ship.serialize()


@pytest.mark.parametrize("mode", ["payload", "truncated", "tampered",
                                  "garbage"])
@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_corrupt_shipments_rejected(package, mode):
    """Both packages reject every corruption of the other's bytes (and of
    their own) with ``TransferIntegrityError``."""
    pytest.importorskip("jax")
    from repro.serving import transfer as rt
    from repro_torch.serving import transfer as pt
    pkg = {"repro": rt, "repro_torch": pt}[package]
    for ship in _shipments("bfloat16"):
        bad = _corrupt(ship.serialize(), mode, pkg)
        with pytest.raises(pkg.TransferIntegrityError):
            pkg.KVShipment.deserialize(bad)


# ---------------------------------------------------------------------------
# engines across the two packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_export_matches_reference(arch):
    """The port's export of a served prompt: the reference's digests,
    parents, tokens and partial tail exactly, its parts and shapes, and
    its KV within ATOL."""
    ref_eng, ref_tokens, port_eng, port_tokens = _sources(arch)
    assert port_tokens == ref_tokens
    want = ref_eng.export_kv_prefix(_prompt(arch))
    got = port_eng.export_kv_prefix(_prompt(arch))
    assert got.n_blocks == want.n_blocks == PROMPT_LEN // 16
    assert got.partial_tokens == want.partial_tokens
    for a, b in zip(got.blocks, want.blocks):
        assert (a.digest, a.parent, a.tokens) == (b.digest, b.parent,
                                                  b.tokens)
        assert set(a.payload) == set(b.payload)
        for part in b.payload:
            for name, arr in b.payload[part].items():
                np.testing.assert_allclose(a.payload[part][name].numpy(),
                                           np.asarray(arr), atol=ATOL,
                                           rtol=0)
        assert a.checksum == payload_checksum(a.payload)
    if arch == "deepseek-moe-16b":
        n_head = _models(arch)[2].cfg.moe.first_dense_layers
        layers = _models(arch)[2].cfg.n_layers
        k = got.blocks[0].payload
        assert set(k) == {"head", "scan"}
        assert k["head"]["k"].shape[0] == n_head
        assert k["scan"]["k"].shape[0] == layers - n_head


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shipment_crosses_packages(arch, direction):
    """A shipment exported by one package, sent as bytes, imports into the
    other's engine bit for bit; that engine then serves the prompt from
    the imported prefix with its own one-engine tokens."""
    ref_src, ref_tokens, port_src, port_tokens = _sources(arch)
    from repro.serving import transfer as rt
    prompt = _prompt(arch)
    if direction == "reference_to_port":
        data = ref_src.export_kv_prefix(prompt).serialize()
        received, dst, want = KVShipment.deserialize(data), \
            _port_engine(arch), port_tokens
    else:
        data = port_src.export_kv_prefix(prompt).serialize()
        received, dst, want = rt.KVShipment.deserialize(data), \
            _ref_engine(arch), ref_tokens
    stats = dst.import_kv_shipment(received)
    assert stats == {"imported": PROMPT_LEN // 16, "dedup_skipped": 0,
                     "dropped_no_space": 0,
                     "tokens_attachable": PROMPT_LEN // 16 * 16}
    _assert_pool_holds(dst, received)
    assert dst.import_kv_shipment(received)["dedup_skipped"] \
        == PROMPT_LEN // 16
    assert _serve(dst, prompt) == want
    assert dst.kv.prefix_hits >= 1


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_snapshot_crosses_packages(direction, tmp_path):
    """``save_prefix_cache`` of either package loads in the other's
    engine, and a warm prompt hits it with unchanged tokens."""
    arch = "gemma-7b"
    ref_src, ref_tokens, port_src, port_tokens = _sources(arch)
    path = str(tmp_path / "prefix.kvship")
    src, dst, want = (ref_src, _port_engine(arch), port_tokens) \
        if direction == "reference_to_port" else \
        (port_src, _ref_engine(arch), ref_tokens)
    nbytes = src.save_prefix_cache(path)
    assert nbytes == Path(path).stat().st_size
    stats = dst.load_prefix_cache(path)
    assert stats["imported"] == len(src.cached_digests()) > 0
    assert dst.cached_digests() == src.cached_digests()
    assert _serve(dst, _prompt(arch)) == want
    assert dst.kv.prefix_hits >= 1


def test_port_snapshot_corruption_detected(tmp_path):
    port_src = _port_engine("gemma-7b")
    _serve(port_src, _prompt("gemma-7b"))
    path = tmp_path / "c.kvship"
    port_src.save_prefix_cache(str(path))
    data = bytearray(path.read_bytes())
    data[-3] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(TransferIntegrityError):
        _port_engine("gemma-7b").load_prefix_cache(str(path))


def test_import_rejects_stripped_unknown_block():
    arch = "gemma-7b"
    ship = _sources(arch)[2].export_kv_prefix(_prompt(arch))
    stripped = ship.drop_payloads({b.digest for b in ship.blocks})
    with pytest.raises(TransferIntegrityError, match="does not hold"):
        _port_engine(arch).import_kv_shipment(stripped)
    wrong = dataclasses.replace(ship, block_size=8)
    with pytest.raises(ValueError, match="block_size"):
        _port_engine(arch).import_kv_shipment(wrong)


def test_import_rejects_pools_of_another_kind():
    """An int8 engine's payload (scales included) does not write into a
    float32 engine's pools, nor a payload of another geometry."""
    arch = "gemma-7b"
    src = _port_engine(arch, cache_dtype=torch.int8)
    _serve(src, _prompt(arch))
    ship = src.export_kv_prefix(_prompt(arch))
    with pytest.raises(ValueError, match="pool-name mismatch"):
        _port_engine(arch).import_kv_shipment(ship)
    fp = _sources(arch)[2].export_kv_prefix(_prompt(arch))
    rec = fp.blocks[0]
    cut = {"scan": {n: a[:1] for n, a in rec.payload["scan"].items()}}
    bad = dataclasses.replace(fp, blocks=[dataclasses.replace(
        rec, payload=cut)])
    with pytest.raises(ValueError, match="geometry mismatch"):
        _port_engine(arch).import_kv_shipment(bad)


def _int8_round_trip(device):
    """An int8-pool shipment (k, v, k_scale, v_scale) serialized,
    deserialized and imported into a second int8 engine: the pools hold
    it bit for bit and the prompt serves with the first engine's tokens."""
    cfg = get_config("gemma-7b").smoke_variant()
    api = build_model(cfg)
    params = api.init(seed=0, device=device, dtype=torch.float32)
    kw = dict(ENGINE, cache_dtype=torch.int8, device=device)
    src, dst = (PagedDecodeEngine(api, params, **kw) for _ in range(2))
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, PROMPT_LEN).astype(np.int32)
    want = _serve(src, prompt)
    ship = src.export_kv_prefix(prompt)
    part = ship.blocks[0].payload["scan"]
    assert set(part) == {"k", "v", "k_scale", "v_scale"}
    assert (part["k"].dtype, part["k_scale"].dtype) == (torch.int8,
                                                        torch.float32)
    received = KVShipment.deserialize(ship.serialize())
    assert dst.import_kv_shipment(received)["imported"] == ship.n_blocks
    _assert_pool_holds(dst, received)
    assert _serve(dst, prompt) == want
    assert dst.kv.prefix_hits >= 1


def test_int8_shipment_round_trip():
    _int8_round_trip("cpu")


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------
def _fleet(vocab, seed=7):
    """Four prompts sharing a 40-token preamble, one short prompt (no full
    block) and an exact duplicate of the first, which is exactly three
    blocks long (its shipped chain covers its whole feed)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, 40).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, vocab, n).astype(
        np.int32)]) for n in (8, *(int(x) for x in rng.integers(3, 9, 3)))]
    prompts.append(rng.integers(0, vocab, 7).astype(np.int32))
    prompts.append(prompts[0].copy())
    return prompts


def _one_engine(make, prompts, max_new, **kw):
    eng = make(**kw)
    for p in prompts:
        eng.submit(p, max_new)
    return {r.request_id: list(r.generated) for r in eng.run_until_drained()}


def _disaggregated(make, prompts, max_new, dis_cls=DisaggregatedEngine,
                   decode_kw=None, **kw):
    dis = dis_cls(make(**kw), make(**kw, **(decode_kw or {})),
                  dc_speedup=8.0)
    for p in prompts:
        dis.submit(p, max_new)
    return dis, {r.request_id: list(r.generated)
                 for r in dis.run_until_drained()}


def _port_maker(api, params, device="cpu"):
    return functools.partial(PagedDecodeEngine, api, params, device=device,
                             cache_dtype=torch.float32, **ENGINE)


@pytest.mark.parametrize("spec", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_disaggregated_matches_one_engine(layout, spec):
    """Prefill -> shipment -> decode gives the one-engine tokens bit for
    bit, with the handoff check on, prefix hits and a CoW fork at the
    edge, and the shared preamble shipped once."""
    cfg = get_config("gemma-7b").smoke_variant()
    api = build_model(cfg)
    params = api.init(seed=0, device="cpu", dtype=torch.float32)
    make = _port_maker(api, params)
    prompts = _fleet(cfg.vocab_size, seed=7 if spec else 11)
    kw = dict(LAYOUTS[layout], spec=spec)
    ref = _one_engine(make, prompts, 8, **kw)
    dis, got = _disaggregated(make, prompts, 8, **kw)
    assert got == ref
    s = dis.stats()
    assert s["handoff_checks"] == len(prompts)
    assert dis.decode.kv.prefix_hits >= 4 and dis.decode.kv.cow_copies >= 1
    assert s["bytes_shipped"] < s["bytes_naive"]
    assert s["blocks_dedup_skipped"] > 0
    assert s["blocks_imported"] + s["blocks_dedup_skipped"] \
        == s["blocks_exported"]
    assert (dis.decode.stats()["ragged"], dis.decode.spec) \
        == (int(layout != "rectangular"), spec)


def test_disaggregated_under_pool_pressure():
    """A decode pool too small to keep every imported block: imports drop
    (counted), the tail recomputes, the tokens stay the one-engine's."""
    cfg = get_config("gemma-7b").smoke_variant()
    api = build_model(cfg)
    params = api.init(seed=0, device="cpu", dtype=torch.float32)
    make = _port_maker(api, params)
    prompts = _fleet(cfg.vocab_size, seed=13)
    ref = _one_engine(make, prompts, 8)
    dis, got = _disaggregated(make, prompts, 8, decode_kw={"num_blocks": 7})
    assert got == ref
    assert dis.decode.stats()["cache_evictions"] > 0


def test_disaggregated_matches_reference():
    """The port's coordinator against the reference's on the same fleet:
    the same tokens, shipped and naive bytes, dedup counts, transfer
    records and simulated clock entries; re-priced at the same walls, the
    same turnaround curve and crossover."""
    arch = "gemma-7b"
    japi, jparams, api, tparams = _models(arch)
    from repro.serving import DisaggregatedEngine as JaxDisaggregated
    prompts = _fleet(api.cfg.vocab_size)
    ref_dis, ref = _disaggregated(functools.partial(_ref_engine, arch),
                                  prompts, 8, dis_cls=JaxDisaggregated)
    dis, got = _disaggregated(_port_maker(api, tparams), prompts, 8)
    assert got == ref
    keys = ("requests", "bytes_naive", "bytes_shipped", "blocks_exported",
            "blocks_dedup_skipped", "blocks_imported", "handoff_checks",
            "transfer_seconds", "sim_seconds")
    assert {k: dis.stats()[k] for k in keys} \
        == {k: ref_dis.stats()[k] for k in keys}
    assert dis.shipments == ref_dis.shipments
    assert [dataclasses.asdict(r) for r in dis.transfer.records] \
        == [dataclasses.asdict(r) for r in ref_dis.transfer.records]
    sim = lambda d: [(e.kind, e.label, e.seconds) for e in d.clock.log
                     if e.kind == "sim"]
    assert sim(dis) == sim(ref_dis)
    assert [(e.kind, e.label) for e in dis.clock.log] \
        == [(e.kind, e.label) for e in ref_dis.clock.log]
    dis.prefill_wall, dis.decode_wall = ref_dis.prefill_wall, \
        ref_dis.decode_wall
    for bw in (None, 1e6, 1.25e8, 1.25e9, 1.25e10):
        assert dis.priced_turnaround(bw) == ref_dis.priced_turnaround(bw)
    assert dis.priced_turnaround(1e9, dc_speedup=2.0,
                                 per_file_startup=0.6) \
        == ref_dis.priced_turnaround(1e9, dc_speedup=2.0,
                                     per_file_startup=0.6)
    for base in (0.01, 1.0, 100.0):
        assert dis.crossover_bandwidth(base) \
            == ref_dis.crossover_bandwidth(base)


def test_disaggregated_rejects_mismatched_engines():
    cfg = get_config("gemma-7b").smoke_variant()
    api = build_model(cfg)
    params = api.init(seed=0, device="cpu", dtype=torch.float32)
    make = _port_maker(api, params)
    with pytest.raises(ValueError, match="block_size"):
        DisaggregatedEngine(make(), make(block_size=8))
    with pytest.raises(ValueError, match="prefix_cache"):
        DisaggregatedEngine(make(), make(prefix_cache=False))


def test_edge_serving_runs_on_cpu():
    """The twin of ``examples/edge_serving.py``: its four stages end in
    its OK line."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.edge_serving", "--device",
         "cpu"], cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "edge_serving OK"
    assert [line[:3] for line in lines if line.startswith("[")] \
        == ["[1]", "[2]", "[3]", "[4]"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """The first CUDA card; skips where there is none (decided here, at
    run time, so that collection needs no card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_disaggregated_through_b1(cuda_device, dtype):
    """On the card: both engines read their pools through the segment-
    tiled kernel only (layers x steps each); the exported blocks sit bit
    for bit in the edge pools; in float32 the handoff is checked and the
    tokens are the one-engine run's."""
    from repro_torch.kernels import paged_attention as pa
    cfg = get_config("gemma-7b").smoke_variant()
    api = build_model(cfg)
    params = api.init(seed=0, device=cuda_device,
                      dtype=getattr(torch, dtype))
    make = functools.partial(PagedDecodeEngine, api, params,
                             device=cuda_device, **ENGINE)
    prompts = _fleet(cfg.vocab_size)
    ref = _one_engine(make, prompts, 8)
    pa.reset_launch_counts()
    dis = DisaggregatedEngine(make(), make(),
                              check_handoff=dtype == "float32")
    received = []
    inner = dis.decode.import_kv_shipment

    def import_and_keep(ship):
        received.append(ship)
        return inner(ship)

    dis.decode.import_kv_shipment = import_and_keep
    for p in prompts:
        dis.submit(p, 8)
    got = {r.request_id: list(r.generated) for r in dis.run_until_drained()}
    launches = {k: v for k, v in pa.launch_counts.items() if v}
    assert launches == {pa.TILED: cfg.n_layers
                        * (dis.prefill.steps + dis.decode.steps)}
    for ship in received:
        _assert_pool_holds(dis.decode, ship)
    if dtype == "float32":
        assert got == ref
    s = dis.stats()
    assert s["blocks_dedup_skipped"] > 0 and s["bytes_shipped"] \
        < s["bytes_naive"]


@pytest.mark.cuda
def test_cuda_int8_shipment_round_trip(cuda_device):
    _int8_round_trip(cuda_device)
