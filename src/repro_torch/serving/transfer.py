"""KV-block wire format + the edge<->DC disaggregated serving coordinator.

The counterpart of ``repro/serving/transfer.py``: prefill in the data
center, decode at the edge, the prompt's paged KV state crossing the WAN
block by block.  Three pieces, as in the reference:

  * **Wire format** — :class:`KVShipment`: the full KV blocks covering a
    prompt prefix, each a :class:`KVBlockRecord` with its chain digest
    (:func:`repro_torch.serving.blocks.chain_digest`), parent digest,
    token ids, per-part K/V payload arrays and a sha256 payload checksum;
    the tokens past the last full block travel as ``partial_tokens``
    (recomputed on the decode side).  ``serialize()`` writes one
    self-describing byte string, ``deserialize()`` verifies every payload
    checksum and recomputes every chain digest, raising
    :class:`TransferIntegrityError` on any corruption, and
    ``drop_payloads()`` strips the blocks the receiver already caches.
    The bytes are the reference's, byte for byte, so a shipment or a
    prefix-cache snapshot crosses between the two packages in both
    directions:

      - payload arrays are tensors (deserialize makes CPU tensors); each
        is hashed and written under its numpy spelling (``float32``,
        ``int8``, ``bfloat16`` and a Python shape tuple), never torch's;
      - numpy has no bfloat16 here, so bf16 arrays go through a 16-bit
        integer view of the same bits under the name ``"bfloat16"``, and
        that name reads back into ``torch.bfloat16`` directly.

  * **Topology** — :func:`edge_dc_topology`: the two-facility ``"dc"`` <->
    ``"edge"`` KV link, with the paper's DTN NIC and RTT constants and a
    streaming per-file startup.

  * **Coordinator** — :class:`DisaggregatedEngine`: each request runs
    prefill -> transfer -> decode across two
    :class:`~repro_torch.serving.engine.PagedDecodeEngine` instances,
    charging DC prefill as *modeled* time (measured wall / ``dc_speedup``),
    the shipment through the
    :class:`~repro_torch.core.transfer.TransferService` cost model, and
    edge decode as *measured* time on one shared
    :class:`~repro_torch.core.simclock.SimClock`; the walls are read after
    the card's queue drains.  ``priced_turnaround()`` re-prices the
    recorded shipments at any link bandwidth and ``crossover_bandwidth()``
    bisects for the bandwidth at which the split beats one-engine serving.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
import time
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core.facility import Facility, Topology, WanLink
from repro_torch.core.simclock import SimClock, device_sync
from repro_torch.core.transfer import DataStore, FileRef, TransferService
from repro_torch.serving.blocks import chain_digest

# part -> {"k": tensor, "v": tensor}, each (n_layers, block_size, Hkv, D);
# int8 pools add "k_scale"/"v_scale" scale planes (n_layers, block_size,
# Hkv)
ArrayPayload = Dict[str, Dict[str, torch.Tensor]]

_MAGIC = b"KVSHIP01"

# wire dtype names (numpy's spelling, which torch's matches after the
# "torch." prefix) -> torch dtypes; bfloat16 travels as 16-bit integers
_DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "bool")}


class TransferIntegrityError(RuntimeError):
    """A shipment failed verification: corrupt payload bytes, a token
    history that no longer hashes to its advertised chain digest, or a
    dedup-stripped block the receiver does not actually hold."""


def _host_array(t: torch.Tensor) -> Tuple[str, Tuple[int, ...], np.ndarray]:
    """(wire dtype name, shape, contiguous host array of the same bytes)
    of one payload tensor."""
    t = t.detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise TypeError(f"no wire format for payload dtype {t.dtype}")
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return name, tuple(t.shape), raw.numpy()


def _bytes_view(raw: np.ndarray) -> np.ndarray:
    """A contiguous host array's bytes as a flat uint8 view (no copy)."""
    return raw.reshape(-1).view(np.uint8)


def _checksum(items) -> str:
    """Sha256 over ``(part, name, dtype, shape, host array)`` items in
    canonical (sorted part, then sorted name) order."""
    h = hashlib.sha256()
    for part, name, dt, shape, raw in sorted(items, key=lambda i: i[:2]):
        h.update(f"{part}/{name}:{dt}:{shape}".encode())
        h.update(_bytes_view(raw))
    return h.hexdigest()


def _items(payload: ArrayPayload):
    return [(part, name, *_host_array(arr))
            for part in payload for name, arr in payload[part].items()]


def payload_checksum(payload: ArrayPayload) -> str:
    """Sha256 over a block payload's canonical byte representation.

    Canonical order is sorted part names, then sorted array names within a
    part (``k``/``v``, plus ``k_scale``/``v_scale`` for int8 pools), with
    each array's dtype and shape mixed into the hash before its raw
    bytes — so a payload that was reshaped, retyped, or bit-flipped in
    flight fails verification even at identical byte length.  The dtype
    is spelled as numpy spells it and the shape is a Python tuple, so the
    digest equals the reference's for the same bytes.
    """
    return _checksum(_items(payload))


def _payload_nbytes(payload: Optional[ArrayPayload]) -> int:
    """Raw KV bytes in one block payload (0 for a stripped payload)."""
    if payload is None:
        return 0
    return sum(t.numel() * t.element_size() for part in payload.values()
               for t in part.values())


@dataclasses.dataclass
class KVBlockRecord:
    """One full KV block on the wire.

    ``digest`` / ``parent`` are chain digests (content addresses — see
    :func:`repro_torch.serving.blocks.chain_digest`), ``tokens`` the
    block's token ids, ``payload`` the per-part K/V arrays read off the
    sender's device pools (``None`` after a dedup strip), and ``checksum``
    the sender-side :func:`payload_checksum` — kept even when the payload
    is stripped, so the record still certifies what the receiver's cached
    copy must contain.
    """

    digest: str
    parent: str
    tokens: List[int]
    payload: Optional[ArrayPayload]
    checksum: str


@dataclasses.dataclass
class KVShipment:
    """A prompt prefix's KV state, packaged for the WAN (or for disk).

    ``blocks`` are the full blocks in chain order (parents before
    children); ``partial_tokens`` the token-history tail past the last
    full block — shipped without KV, recomputed on the decode side.
    One serialized shipment is one stored object but logically
    ``1 + n_payloads`` wire files (manifest + per-block payloads); the
    transfer cost model prices it that way via its ``n_files`` override.
    """

    block_size: int
    blocks: List[KVBlockRecord]
    partial_tokens: List[int]

    # ------------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        """Full blocks described by the shipment (with or without KV)."""
        return len(self.blocks)

    @property
    def n_payloads(self) -> int:
        """Blocks still carrying their KV payload (not dedup-stripped)."""
        return sum(1 for b in self.blocks if b.payload is not None)

    @property
    def payload_nbytes(self) -> int:
        """Raw KV bytes across all carried payloads."""
        return sum(_payload_nbytes(b.payload) for b in self.blocks)

    @property
    def tokens_covered(self) -> int:
        """Prompt tokens whose KV the full blocks cover."""
        return self.n_blocks * self.block_size

    # ------------------------------------------------------------------
    def drop_payloads(self, present: Union[Set[str], FrozenSet[str]]
                      ) -> "KVShipment":
        """Dedup against the receiver: strip payloads of blocks whose
        digest the receiver already caches.

        The records themselves stay (digest + tokens + checksum), so the
        receiver can verify the chain and assert it really holds every
        stripped block.  Returns a new shipment; payload arrays are shared,
        not copied.
        """
        blocks = [b if b.digest not in present else
                  dataclasses.replace(b, payload=None)
                  for b in self.blocks]
        return KVShipment(self.block_size, blocks, list(self.partial_tokens))

    # ------------------------------------------------------------------
    def serialize(self) -> bytes:
        """Pack the shipment into one self-describing byte string.

        Layout: ``KVSHIP01`` magic, little-endian uint32 header length, a
        JSON header (digests, tokens, checksums, array dtypes/shapes),
        then the raw array buffers concatenated in header order.  The
        header is canonical (sorted keys), so identical shipments
        serialize to identical bytes on any host and in either package.
        """
        buffers: List[Any] = []
        blocks_hdr = []
        for rec in self.blocks:
            arrays = None
            if rec.payload is not None:
                arrays = []
                for part in sorted(rec.payload):
                    for name in sorted(rec.payload[part]):
                        dt, shape, raw = _host_array(rec.payload[part][name])
                        arrays.append({"part": part, "name": name,
                                       "dtype": dt, "shape": list(shape),
                                       "nbytes": raw.nbytes})
                        buffers.append(_bytes_view(raw))
            blocks_hdr.append({"digest": rec.digest, "parent": rec.parent,
                               "tokens": rec.tokens,
                               "checksum": rec.checksum, "arrays": arrays})
        header = {"block_size": self.block_size,
                  "partial_tokens": [int(t) for t in self.partial_tokens],
                  "blocks": blocks_hdr}
        hjson = json.dumps(header, sort_keys=True,
                           separators=(",", ":")).encode()
        return b"".join([_MAGIC, struct.pack("<I", len(hjson)), hjson,
                         *buffers])

    @classmethod
    def deserialize(cls, data: bytes) -> "KVShipment":
        """Unpack and *verify* a serialized shipment into CPU tensors.

        Every carried payload's checksum is recomputed over the decoded
        arrays, and every block's chain digest is recomputed from its
        ``(parent, tokens)`` — a mismatch in either raises
        :class:`TransferIntegrityError`, so a corrupted shipment can never
        be attached to a sequence.
        """
        if data[:len(_MAGIC)] != _MAGIC:
            raise TransferIntegrityError(
                "not a KV shipment (bad magic/version)")
        off = len(_MAGIC)
        (hlen,) = struct.unpack_from("<I", data, off)
        off += 4
        try:
            header = json.loads(bytes(data[off:off + hlen]).decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise TransferIntegrityError(f"corrupt shipment header: {e}")
        off += hlen
        blocks: List[KVBlockRecord] = []
        for bh in header["blocks"]:
            items = None
            if bh["arrays"] is not None:
                items = []
                for ah in bh["arrays"]:
                    nbytes = ah["nbytes"]
                    if off + nbytes > len(data):
                        raise TransferIntegrityError(
                            "truncated shipment: payload bytes missing")
                    if ah["dtype"] not in _DTYPES:
                        raise TransferIntegrityError(
                            f"unknown payload dtype {ah['dtype']!r}")
                    host = np.int16 if ah["dtype"] == "bfloat16" \
                        else ah["dtype"]
                    raw = np.frombuffer(data, dtype=host,
                                        count=nbytes // np.dtype(host)
                                        .itemsize, offset=off)
                    raw = raw.reshape(ah["shape"])
                    items.append((ah["part"], ah["name"], ah["dtype"],
                                  tuple(raw.shape), raw))
                    off += nbytes
            rec = KVBlockRecord(digest=bh["digest"], parent=bh["parent"],
                                tokens=[int(t) for t in bh["tokens"]],
                                payload=None, checksum=bh["checksum"])
            if chain_digest(rec.parent, rec.tokens) != rec.digest:
                raise TransferIntegrityError(
                    f"chain digest mismatch for block {rec.digest[:12]}: "
                    "token history corrupted in flight")
            if items is not None:
                if _checksum(items) != rec.checksum:
                    raise TransferIntegrityError(
                        f"payload checksum mismatch for block "
                        f"{rec.digest[:12]}: KV bytes corrupted in flight")
                rec.payload = {}
                for part, name, dt, _, raw in items:
                    t = torch.from_numpy(raw.copy())
                    if dt == "bfloat16":
                        t = t.view(torch.bfloat16)
                    rec.payload.setdefault(part, {})[name] = t
            blocks.append(rec)
        return cls(block_size=int(header["block_size"]), blocks=blocks,
                   partial_tokens=[int(t)
                                   for t in header["partial_tokens"]])


# ---------------------------------------------------------------------------
def edge_dc_topology(nic_bps: float = 1.25e9, *, backbone_bps: float = 12.5e9,
                     rtt: float = 0.048,
                     per_file_startup: float = 0.05) -> Topology:
    """Two-facility topology for the KV link: ``"dc"`` <-> ``"edge"``.

    Defaults mirror the paper's deployment constants (10 Gbps DTN NIC =
    1.25 GB/s, 100 Gbps backbone, 48 ms RTT) except ``per_file_startup``:
    a streaming KV handoff rides a persistent session, so ``S`` here is
    per-batch connection setup (~50 ms), not the 0.6 s Globus task
    submission the bulk-file model pays.  Pass ``per_file_startup=0.6`` to
    price shipments as individual Globus tasks instead.
    """
    topo = Topology()
    topo.add_facility(Facility("dc"))
    topo.add_facility(Facility("edge"))
    for src, dst in (("dc", "edge"), ("edge", "dc")):
        topo.add_link(WanLink(src, dst, backbone_bps=backbone_bps,
                              nic_bps=nic_bps, rtt=rtt,
                              per_file_startup=per_file_startup))
    return topo


# ---------------------------------------------------------------------------
class DisaggregatedEngine:
    """Prefill at the DC, decode at the edge, KV blocks over the WAN.

    Wraps two :class:`~repro_torch.serving.engine.PagedDecodeEngine`
    instances (both with the prefix cache enabled, same ``block_size``)
    behind the familiar ``submit`` / ``run_until_drained`` surface.  Per
    drained batch:

      1. **DC prefill** — every pending prompt runs on the prefill engine
         for exactly one new token (continuous-batched together).  Wall
         time is measured, then *charged* to the clock as
         ``wall / dc_speedup``.  The emitted first token rides along as a
         handoff cross-check.
      2. **Transfer** — each prompt's full KV blocks are exported
         (:meth:`PagedDecodeEngine.export_kv_prefix`), dedup-stripped
         against the decode engine's cached digests, serialized, and
         submitted to the :class:`~repro_torch.core.transfer.TransferService`,
         which prices them with the paper's ``T = x/v + S`` model and
         advances the shared clock.
      3. **Edge decode** — the decode engine imports the shipment
         (verify -> register -> device-pool write), then serves the
         request normally: ``begin_seq`` attaches the imported chain as a
         prefix hit, the partial tail recomputes, and decode proceeds
         with tiling and speculation unchanged.  Wall time is measured
         into the clock.  Greedy decoding makes the handoff token-identical
         to single-engine serving wherever the two batch shapes round
         alike (always in float32 on the CPU) — asserted against the
         DC-emitted first token when ``check_handoff`` is on.

    Dedup accounting (``bytes_naive`` vs ``bytes_shipped``) quantifies
    what content-addressing saves on prefix-heavy fleets; the recorded
    shipments let :meth:`priced_turnaround` re-price the run at any link
    bandwidth and :meth:`crossover_bandwidth` locate where the split
    beats one-engine serving.
    """

    def __init__(self, prefill_engine, decode_engine, *,
                 transfer: Optional[TransferService] = None,
                 clock: Optional[SimClock] = None,
                 dc: str = "dc", edge: str = "edge",
                 nic_bps: float = 1.25e9, dc_speedup: float = 8.0,
                 concurrency: int = 8,
                 check_handoff: bool = True) -> None:
        """Wire the coordinator to its two engines and the cost model.

        With no ``transfer`` service given, a private one is built over
        :func:`edge_dc_topology` at ``nic_bps`` (fault-free, deterministic).
        ``dc_speedup`` is the modeled DCAI-vs-edge compute ratio applied to
        the measured prefill wall; ``concurrency`` the WAN stream count.
        """
        if prefill_engine.block_size != decode_engine.block_size:
            raise ValueError(
                "prefill and decode engines must share block_size "
                f"({prefill_engine.block_size} != "
                f"{decode_engine.block_size}): chain digests are computed "
                "over block-sized token runs")
        for name, eng in (("prefill", prefill_engine),
                          ("decode", decode_engine)):
            if not eng.kv.enable_prefix_cache:
                raise ValueError(
                    f"{name} engine needs prefix_cache=True: the prefix "
                    "cache is both the export source and the import target")
        self.prefill = prefill_engine
        self.decode = decode_engine
        self.dc = dc
        self.edge = edge
        self.dc_speedup = float(dc_speedup)
        self.concurrency = int(concurrency)
        self.check_handoff = check_handoff
        if transfer is None:
            clock = clock or SimClock()
            transfer = TransferService(edge_dc_topology(nic_bps), clock,
                                       DataStore(),
                                       default_concurrency=concurrency)
        self.transfer = transfer
        self.clock = transfer.clock
        # both sides stamp t_submit / t_first_token / t_done from the
        # shared virtual clock, so disaggregated TTFT rows are comparable
        # with wall-clock engines (same stamping code, different clock)
        self.prefill.set_clock(self.clock)
        self.decode.set_clock(self.clock)
        self._pending: List[tuple] = []
        self._next_id = 0
        self._shipment_counter = 0
        # accounting the crossover analysis reads
        self.prefill_wall = 0.0
        self.decode_wall = 0.0
        self.transfer_seconds = 0.0
        self.bytes_naive = 0
        self.bytes_shipped = 0
        self.blocks_exported = 0
        self.blocks_dedup_skipped = 0
        self.blocks_imported = 0
        self.partial_tokens_reshipped = 0
        self.handoff_checks = 0
        # (wire bytes, logical file count) per shipment, for re-pricing
        self.shipments: List[tuple] = []

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        """Queue a request for the next drain; returns its request id."""
        rid = self._next_id
        self._next_id += 1
        self._pending.append((rid, np.asarray(prompt, np.int32),
                              int(max_new_tokens)))
        return rid

    # ------------------------------------------------------------------
    def _ship_one(self, prompt: np.ndarray) -> Dict[str, int]:
        """Export -> dedup -> transfer -> import one prompt's KV prefix.

        Returns the decode-side import stats for the shipment.  Dedup is
        content-addressed: blocks another request in this very batch
        already shipped are stripped too, so a shared preamble crosses the
        WAN exactly once.
        """
        shipment = self.prefill.export_kv_prefix(prompt)
        self.blocks_exported += shipment.n_blocks
        self.partial_tokens_reshipped += len(shipment.partial_tokens)
        naive = len(shipment.serialize())
        deduped = shipment.drop_payloads(self.decode.cached_digests())
        wire = deduped.serialize()
        self.bytes_naive += naive
        self.bytes_shipped += len(wire)
        self.blocks_dedup_skipped += deduped.n_blocks - deduped.n_payloads

        self._shipment_counter += 1
        name = f"kvship-{self._shipment_counter:05d}"
        self.transfer.store.put(self.dc, FileRef(name, len(wire),
                                                 payload=wire))
        n_files = 1 + deduped.n_payloads        # manifest + block payloads
        self.transfer.submit(self.dc, self.edge, [name],
                             concurrency=self.concurrency, n_files=n_files,
                             label=f"{name} kv {self.dc}->{self.edge}")
        self.shipments.append((len(wire), n_files))

        received = KVShipment.deserialize(
            self.transfer.store.get(self.edge, name).payload)
        stats = self.decode.import_kv_shipment(received)
        self.blocks_imported += stats["imported"]
        return stats

    def run_until_drained(self) -> List[Any]:
        """Serve every queued request through prefill->transfer->decode.

        Returns the finished :class:`~repro_torch.serving.scheduler.Request`
        objects (re-keyed to this coordinator's request ids, in id order)
        — the same objects single-engine ``run_until_drained`` would hand
        back.
        """
        out: List[Any] = []
        while self._pending:
            batch, self._pending = self._pending, []

            # 1. DC prefill: one continuous batch, one emitted token each
            pre_ids = {}
            for rid, prompt, _ in batch:
                pre_ids[self.prefill.submit(prompt, 1)] = rid
            device_sync()
            t0 = time.perf_counter()
            pre_done = self.prefill.run_until_drained()
            device_sync()
            wall = time.perf_counter() - t0
            self.prefill_wall += wall
            self.clock.charge(wall / self.dc_speedup,
                              f"dc prefill x{len(batch)} (modeled DCAI)")
            first_tok = {pre_ids[r.request_id]: r.generated[:1]
                         for r in pre_done}

            # 2+3. ship KV, then decode at the edge
            dec_ids = {}
            for rid, prompt, max_new in batch:
                self._ship_one(prompt)
                dec_ids[self.decode.submit(prompt, max_new)] = rid
            with self.clock.measure(f"edge decode x{len(batch)}"):
                t0 = time.perf_counter()
                dec_done = self.decode.run_until_drained()
                device_sync()
                self.decode_wall += time.perf_counter() - t0
            for r in dec_done:
                rid = dec_ids[r.request_id]
                expect = first_tok.get(rid)
                if self.check_handoff and expect:
                    self.handoff_checks += 1
                    if r.generated[:1] != expect:
                        raise RuntimeError(
                            f"disaggregated handoff diverged on request "
                            f"{rid}: DC prefill emitted {expect[0]}, edge "
                            f"decode emitted {r.generated[0]} — the "
                            "shipped KV does not reproduce the prompt "
                            "state")
                r.request_id = rid
                out.append(r)
        self.transfer_seconds = sum(r.duration
                                    for r in self.transfer.records)
        return sorted(out, key=lambda r: r.request_id)

    # ------------------------------------------------------------------
    def priced_turnaround(self, nic_bps: Optional[float] = None, *,
                          dc_speedup: Optional[float] = None,
                          per_file_startup: Optional[float] = None
                          ) -> Dict[str, float]:
        """Re-price the recorded run at a different link bandwidth.

        Uses the measured prefill/decode walls and the recorded shipment
        sizes, recomputing only the transfer term with the §4.1 model at
        ``nic_bps`` — so one served fleet yields the whole
        turnaround-vs-bandwidth curve without re-running the model.
        Returns ``{"prefill", "transfer", "decode", "total"}`` seconds.
        """
        speedup = self.dc_speedup if dc_speedup is None else dc_speedup
        if nic_bps is None:
            xfer = sum(r.duration for r in self.transfer.records)
        else:
            kw = {} if per_file_startup is None \
                else {"per_file_startup": per_file_startup}
            link = edge_dc_topology(nic_bps, **kw).link("dc", "edge")
            xfer = 0.0
            for nbytes, n_files in self.shipments:
                conc = min(self.concurrency, n_files)
                v = link.effective_rate(conc)
                startup = link.per_file_startup * \
                    ((n_files + conc - 1) // conc)
                xfer += nbytes / v + startup + 2 * link.rtt
        prefill = self.prefill_wall / max(speedup, 1e-9)
        return {"prefill": prefill, "transfer": xfer,
                "decode": self.decode_wall,
                "total": prefill + xfer + self.decode_wall}

    def crossover_bandwidth(self, baseline_seconds: float, *,
                            lo: float = 1e4, hi: float = 1e13,
                            iters: int = 60) -> Optional[float]:
        """Smallest link bandwidth (bytes/s) at which the disaggregated
        turnaround beats ``baseline_seconds`` (one-engine serving).

        Bisects the monotone transfer term of :meth:`priced_turnaround`.
        Returns ``None`` when even an infinite link loses (the fixed
        startup + control cost exceeds the DC compute win) and ``lo`` when
        even the slowest probed link wins.
        """
        if self.priced_turnaround(hi)["total"] > baseline_seconds:
            return None
        if self.priced_turnaround(lo)["total"] <= baseline_seconds:
            return lo
        a, b = lo, hi
        for _ in range(iters):
            mid = (a * b) ** 0.5          # geometric: bandwidth spans decades
            if self.priced_turnaround(mid)["total"] <= baseline_seconds:
                b = mid
            else:
                a = mid
        return b

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Coordinator accounting: walls, clock breakdown, dedup bytes."""
        bd = self.clock.breakdown()
        return {
            "requests": self._next_id,
            "prefill_wall": self.prefill_wall,
            "decode_wall": self.decode_wall,
            "transfer_seconds": self.transfer_seconds,
            "turnaround": bd["total"],
            "modeled_seconds": bd["modeled"],
            "sim_seconds": bd["sim"],
            "real_seconds": bd["real"],
            "bytes_naive": self.bytes_naive,
            "bytes_shipped": self.bytes_shipped,
            "dedup_savings": 1.0 - self.bytes_shipped
            / max(self.bytes_naive, 1),
            "blocks_exported": self.blocks_exported,
            "blocks_dedup_skipped": self.blocks_dedup_skipped,
            "blocks_imported": self.blocks_imported,
            "handoff_checks": self.handoff_checks,
        }
