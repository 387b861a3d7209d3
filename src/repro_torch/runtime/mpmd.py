"""Multi-controller (``mpmd``) runtime: one controller thread per rank,
each running ONLY its own rank's program.  Port of ``repro.runtime.mpmd``.

The whole-mesh runtime (``runtime/spmd.py``) walks every rank's tasks
from one controller.  This one compiles ``GlobalPlan.rank_program(r)``
into a per-rank program holding only rank r's chunks, sends, recvs and
collective posts (``trace_sizes()`` against ``SpmdExecutor.trace_size()``
counts the shrink), and N controller threads run the N programs at once,
communicating through an asynchronous message transport.  Each thread
runs its rank on the rank's device and, on the card, under
``torch.cuda.stream`` of the rank's own stream (the current stream is
thread-local in PyTorch); on the CPU every rank runs on the CPU.

IR op -> transport lowering (the mirror of ``runtime/spmd.py``'s table):

  chunk                 run eagerly by the rank's thread; feeds and params
                        resolved per rank
  p2p send              posts the payload on the tagged channel
                        (node, src, dst)
  p2p recv              blocks on that channel and checks the payload
                        against the receiver's wire shape (``ValueSpec``)
  all_gather (param)    the rank's 1/|group| byte shard of the bucket's
                        bit-cast params goes through a subgroup rendezvous;
                        every member rebuilds the full byte vector into
                        the gathered tree its chunks read
  all_reduce /          every member posts its accumulated (count, tree)
  reduce_scatter (grad) to the subgroup rendezvous; the group's lowest
                        rank folds the contributions in the interpreter's
                        own advance order with the reference formula
                        ``sum(x/c)/n`` and hands the mean to the
                        controller epilogue
  all_to_all (EP)       rendezvous round trip: each member's block crosses
                        the transport and returns (identity values)
  d2h / h2d (Offload)   rank-local identity

Transports (one ``_Board`` semantics, two wire shapes):

  ``transport="inproc"``  threads + queues + condition-variable
                          rendezvous in-process: a payload is a tensor
                          tree handed over with an event recorded on the
                          sender's stream; the receiver waits on it on its
                          own stream and copies into memory it owns;
  ``transport="tcp"``     the same board behind a localhost TCP server:
                          each payload goes to bytes (dtype name, shape
                          and the raw buffer of a ``view(torch.uint8)`` on
                          the CPU, bf16 as raw bits), crosses a socket with
                          length-prefixed framing and comes back on the
                          receiver's device.

Startup handshake (the PIPER025 gate): before any program runs, every
rank serializes its typed interface signature
(``GlobalPlan.rank_signature``) and exchanges it with all peers over the
transport; each rank then pairwise-validates every p2p channel and
collective group it is party to.  A mismatch raises
``MpmdHandshakeError`` naming both ranks (``signature_overrides=`` is the
fault-injection seam).

Bit-parity with the interpreter, as in the JAX package: each rank's
compute and collective order IS the interpreter's dynamic dispatch order
restricted to that rank (``replay_schedule``), reductions fold in the
interpreter's member order with its formula, and the controller epilogue
applies the reference loss and grad reductions in ``ScheduleReplay``
order.  The interpreter reads p2p values straight from the producer's
store, so its global order may run a recv before its send; a blocking
transport would deadlock there, so ``_rank_orders`` re-derives each
rank's order by replaying the task graph under blocking-transport
semantics, pinning every compute and collective to its replay position
(a witness interleaving: its per-rank projections cannot deadlock).

A plan that fails ``validate_comm_order`` is rejected at construction,
before any thread starts; a rank that stalls trips the transport timeout
and poisons all peers (``MpmdTransportError``).  The kernel library is
built before the threads start, so that no timeout covers an ``nvcc``
build.
"""
from __future__ import annotations

import contextlib
import json
import pickle
import socket
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Sequence

import torch

from ..core.compiler import CompiledProgram
from ..core.dag import dtype_name
from ..core.plan import ROLE_COLL, ROLE_COMPUTE, ROLE_RECV, ROLE_SEND
from ..core.scheduler import validate_comm_order
from ..tree import tree_map
from .executor import register_backend
from .interpreter import Interpreter, RunResult, ScheduleReplay, _PlanWalker
from .spmd import (Ranks, RankState, _Lane, _recipe, _shard_bytes, _split_buckets,
                   final_grads, fold_mean, grad_members, keep_reduced, mean_loss,
                   new_rank_states, passthrough, place_ranks, release_inputs, run_chunk,
                   tree_bytes)


class MpmdBackendError(RuntimeError):
    """The MPMD executor cannot run this plan on the available devices."""


class MpmdHandshakeError(MpmdBackendError):
    """The startup signature handshake found peers whose typed
    interfaces disagree (the dynamic PIPER025) — the executor refuses
    to start."""


class MpmdTransportError(RuntimeError):
    """A transport operation timed out or was poisoned by a failing
    peer — the dynamic analogue of the PIPER001 deadlock the static
    verifier rejects."""


# ---------------------------------------------------------------------------
# message board: tagged channels + keyed rendezvous
# ---------------------------------------------------------------------------

class _Board:
    """The one message-passing semantics both transports implement:
    FIFO channels keyed by tag (p2p) and all-post/all-fetch rendezvous
    slots keyed by op instance (collectives).  ``abort`` poisons every
    current and future waiter so one failing rank cannot strand its
    peers at a rendezvous."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._chan: dict[tuple, deque] = {}
        self._rdv: dict[tuple, dict] = {}
        self._poison: Optional[str] = None

    def _check(self) -> None:
        if self._poison is not None:
            raise MpmdTransportError(f"transport poisoned: {self._poison}")

    def reset(self) -> None:
        with self._cv:
            self._chan.clear()
            self._rdv.clear()
            self._poison = None
            self._cv.notify_all()

    def abort(self, msg: str) -> None:
        with self._cv:
            if self._poison is None:
                self._poison = msg
            self._cv.notify_all()

    def send(self, tag: tuple, payload) -> None:
        with self._cv:
            self._check()
            self._chan.setdefault(tag, deque()).append(payload)
            self._cv.notify_all()

    def recv(self, tag: tuple, timeout: float):
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                self._check()
                q = self._chan.get(tag)
                if q:
                    return q.popleft()
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    raise MpmdTransportError(
                        f"recv on channel {tag} timed out after {timeout:.0f}s — peer never "
                        "sent (the dynamic analogue of a PIPER001 desync)")

    def gather(self, key: tuple, pos: int, nposts: int, payload, timeout: float,
               want=None) -> list:
        """Rendezvous allgather: post as member ``pos`` of ``nposts``,
        block until all members posted, return payloads in pos order
        (only the positions in ``want``, if given; None for the rest).
        The last fetcher retires the slot."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._check()
            slot = self._rdv.setdefault(key, {"posts": {}, "taken": 0})
            slot["posts"][pos] = payload
            self._cv.notify_all()
            while len(slot["posts"]) < nposts:
                self._check()
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    missing = sorted(set(range(nposts)) - set(slot["posts"]))
                    raise MpmdTransportError(
                        f"rendezvous {key} timed out after {timeout:.0f}s waiting for "
                        f"member(s) {missing} of {nposts}")
            out = [slot["posts"][p] if want is None or p in want else None
                   for p in sorted(slot["posts"])]
            slot["taken"] += 1
            if slot["taken"] >= nposts:
                self._rdv.pop(key, None)
            return out


def _map_tensors(fn, obj):
    """``fn`` over every tensor in a payload of dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


class _Handoff(NamedTuple):
    """An inproc payload: the sender's tensors and the event recorded on
    the sender's stream after it produced them (None on the CPU)."""
    payload: Any
    event: Any


class InprocTransport:
    """Threads sharing one in-process board.  Every payload still flows
    through the board (no rank reads another's store): the receiver waits
    on the sender's event on its own stream and copies the tensors into
    memory it owns; the sender's blocks are kept from reuse until that
    copy has run (``Ranks.own``)."""
    name = "inproc"

    def __init__(self) -> None:
        self._board = _Board()

    def reset(self) -> None:
        self._board.reset()

    def abort(self, msg: str) -> None:
        self._board.abort(msg)

    @staticmethod
    def _pack(payload, ranks: Optional[Ranks], r: Optional[int]) -> _Handoff:
        return _Handoff(payload, None if ranks is None else ranks.event(r))

    @staticmethod
    def _unpack(h: _Handoff, ranks: Optional[Ranks], r: Optional[int]):
        if ranks is None:           # a payload without tensors (the handshake)
            return h.payload
        return _map_tensors(lambda t: ranks.own(t, r, h.event), h.payload)

    def send(self, tag, payload, ranks: Optional[Ranks] = None, r: Optional[int] = None) -> None:
        self._board.send(tag, self._pack(payload, ranks, r))

    def recv(self, tag, timeout, ranks: Optional[Ranks] = None, r: Optional[int] = None):
        return self._unpack(self._board.recv(tag, timeout), ranks, r)

    def gather(self, key, pos, nposts, payload, timeout, ranks: Optional[Ranks] = None,
               r: Optional[int] = None, want=None) -> list:
        """The members' payloads in pos order, each ``want``-ed one (all
        by default) copied into rank ``r``'s memory on its stream, the
        others None.  ``ranks`` is None for payloads without tensors."""
        posts = self._board.gather(key, pos, nposts, self._pack(payload, ranks, r), timeout,
                                   want)
        return [None if h is None else self._unpack(h, ranks, r) for h in posts]

    def close(self) -> None:
        pass


class _Wire(NamedTuple):
    """A tensor on the wire: dtype name, shape, and its raw bytes (a
    numpy uint8 array, which pickles as one buffer)."""
    dtype: str
    shape: tuple
    data: Any


def _to_wire(t: torch.Tensor) -> _Wire:
    """The tensor's bytes through host memory: a ``view(torch.uint8)``
    copied to the CPU (bf16 as raw bits; the copy waits for the current
    stream's work)."""
    flat = t.detach().contiguous().reshape(-1)
    u8 = flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)
    return _Wire(dtype_name(t.dtype), tuple(t.shape), u8.cpu().numpy())


def _from_wire(w: _Wire, device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, w.dtype)
    u8 = torch.from_numpy(w.data)
    return (u8 if dtype == torch.uint8 else u8.view(dtype)).reshape(w.shape).to(device)


class TcpTransport:
    """The same board behind a localhost TCP server: every operation is
    a length-prefixed pickled request over a fresh socket, so every
    cross-rank payload crosses a real OS socket as bytes (blocking ops
    block their server-side connection thread).  Only this process's
    own requests are ever unpickled."""
    name = "tcp"

    def __init__(self) -> None:
        self._board = _Board()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(128)
        self.address = self._srv.getsockname()
        self._closing = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="mpmd-tcp-accept", daemon=True)
        self._accept_thread.start()

    # -- framing ---------------------------------------------------------
    # A message is its pickle, with every tensor's bytes (numpy buffers)
    # taken out of band: a header of sizes, the pickle, then each buffer
    # as it is, so no payload byte is copied by Python on either side.
    @staticmethod
    def _send_msg(sock, obj) -> None:
        buffers: list = []
        data = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
        views = [b.raw() for b in buffers]
        sock.sendall(struct.pack(f">QI{len(views)}Q", len(data), len(views),
                                 *(v.nbytes for v in views)))
        sock.sendall(data)
        for v in views:
            sock.sendall(v)

    @staticmethod
    def _recv_exactly(sock, n: int) -> bytearray:
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = sock.recv_into(view[got:], min(1 << 24, n - got))
            if not k:
                raise ConnectionError("peer closed")
            got += k
        return buf

    @classmethod
    def _recv_msg(cls, sock):
        n, k = struct.unpack(">QI", cls._recv_exactly(sock, 12))
        sizes = struct.unpack(f">{k}Q", cls._recv_exactly(sock, 8 * k)) if k else ()
        data = cls._recv_exactly(sock, n)
        return pickle.loads(data, buffers=[cls._recv_exactly(sock, m) for m in sizes])

    # -- server ----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,), daemon=True).start()

    def _serve_one(self, conn) -> None:
        try:
            with conn:
                op, args = self._recv_msg(conn)
                try:
                    result = getattr(self._board, op)(*args)
                    self._send_msg(conn, (True, result))
                except Exception as e:  # marshalled to the client
                    self._send_msg(conn, (False, f"{type(e).__name__}: {e}"))
        except (ConnectionError, OSError):
            pass

    # -- client ----------------------------------------------------------
    def _call(self, op: str, *args):
        with socket.create_connection(self.address, timeout=600) as sock:
            self._send_msg(sock, (op, args))
            ok, result = self._recv_msg(sock)
        if not ok:
            raise MpmdTransportError(result)
        return result

    def reset(self) -> None:
        self._call("reset")

    def abort(self, msg: str) -> None:
        self._call("abort", msg)

    def send(self, tag, payload, ranks: Optional[Ranks] = None, r: Optional[int] = None) -> None:
        self._call("send", tag, _map_tensors(_to_wire, payload))

    def recv(self, tag, timeout, ranks: Optional[Ranks] = None, r: Optional[int] = None):
        return _map_wires(self._call("recv", tag, timeout), ranks and ranks.dev[r])

    def gather(self, key, pos, nposts, payload, timeout, ranks: Optional[Ranks] = None,
               r: Optional[int] = None, want=None) -> list:
        """As ``InprocTransport.gather``; only the ``want``-ed posts come
        back over the socket."""
        posts = self._call("gather", key, pos, nposts, _map_tensors(_to_wire, payload),
                           timeout, None if want is None else list(want))
        return [_map_wires(p, ranks and ranks.dev[r]) for p in posts]

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass


def _map_wires(obj, device):
    if isinstance(obj, _Wire):
        return _from_wire(obj, device)
    if isinstance(obj, dict):
        return {k: _map_wires(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_wires(v, device) for v in obj)
    return obj


_TRANSPORTS = {"inproc": InprocTransport, "tcp": TcpTransport}


# ---------------------------------------------------------------------------
# rank-signature serialization (the handshake payload)
# ---------------------------------------------------------------------------

def serialize_rank_signature(sig: dict) -> bytes:
    """Deterministic wire form of ``GlobalPlan.rank_signature``: specs
    as stable reprs, groups as lists — byte-comparable and corruptible
    (the ``signature_overrides`` test seam)."""
    return json.dumps({
        "device": sig["device"],
        "sends": [[p, n, repr(s)] for (p, n, s) in sig["sends"]],
        "recvs": [[p, n, repr(s)] for (p, n, s) in sig["recvs"]],
        "collectives": [[list(g), n, op, payload, [repr(s) for s in specs]]
                        for (g, n, op, payload, specs) in sig["collectives"]],
    }, sort_keys=True).encode()


def _pairwise_errors(r: int, mine: dict, peers: dict[int, dict]) -> list[str]:
    """Rank r's view of the PIPER025 pairwise agreement: every p2p
    channel r is party to, both directions, and every collective group
    containing r — mirroring ``analysis.rank_interface_diagnostics``."""
    errs: list[str] = []

    def chan_seqs(src_sig, dst_sig, src, dst):
        s_seq = [(n, sp) for (p, n, sp) in src_sig["sends"] if p == dst]
        r_seq = [(n, sp) for (p, n, sp) in dst_sig["recvs"] if p == src]
        return s_seq, r_seq

    out_peers = {p for (p, _, _) in mine["sends"]}
    in_peers = {p for (p, _, _) in mine["recvs"]}
    for p in sorted(out_peers | in_peers):
        if p not in peers:
            errs.append(f"[PIPER025] rank {r} names rank {p} in its "
                        "interface but no such rank joined the handshake")
            continue
        for (src, dst), (src_sig, dst_sig) in (
                ((r, p), (mine, peers[p])), ((p, r), (peers[p], mine))):
            s_seq, r_seq = chan_seqs(src_sig, dst_sig, src, dst)
            if len(s_seq) != len(r_seq):
                errs.append(
                    f"[PIPER025] rank {src} sends {len(s_seq)} p2p "
                    f"payload(s) to rank {dst} but rank {dst}'s program "
                    f"expects {len(r_seq)} — the per-rank programs "
                    "would desync")
                continue
            for i, ((snid, ss), (rnid, rs)) in enumerate(zip(s_seq, r_seq)):
                if ss != rs and "None" not in (ss, rs):
                    errs.append(
                        f"[PIPER025] p2p interface mismatch on channel "
                        f"rank {src} -> rank {dst} at position {i} "
                        f"(nodes {snid}/{rnid}): the sender supplies "
                        f"{ss} but the receiver was wired for {rs}")

    groups = {tuple(g) for (g, *_rest) in mine["collectives"]}
    for g in sorted(groups):
        ref = [c[1:] for c in mine["collectives"] if tuple(c[0]) == g]
        for m in g:
            if m == r:
                continue
            if m not in peers:
                errs.append(f"[PIPER025] collective group {list(g)} "
                            f"names rank {m} but it never joined the "
                            "handshake")
                continue
            seq = [c[1:] for c in peers[m]["collectives"] if tuple(c[0]) == g]
            if seq == ref:
                continue
            pos = next((i for i, (a, b) in enumerate(zip(ref, seq)) if a != b),
                       min(len(ref), len(seq)))
            errs.append(
                f"[PIPER025] collective signature of group {list(g)} "
                f"diverges between rank {r} ({len(ref)} dispatches) "
                f"and rank {m} ({len(seq)} dispatches) at position "
                f"{pos} — an MPMD rendezvous would hang or corrupt")
    return errs


# ---------------------------------------------------------------------------
# wire-shape oracle
# ---------------------------------------------------------------------------

class _ShapeOracle(_PlanWalker):
    """Device-aware abstract interpretation of one batch signature.

    IR ``ValueSpec``s are *logical* shapes — a DP-replicated producer
    declares ``(mb, d)`` while each device actually emits its
    ``(mb/dp, d)`` shard — so a receiver cannot learn its wire shape
    from the edge spec alone.  This pass walks the interpreter's own
    dispatch loop (it IS the ``_PlanWalker`` replay, so the executor gets
    the ``ScheduleReplay`` and the shapes from ONE walk) with each chunk
    run on meta tensors (the kernels' wrappers compute shapes only there),
    propagating per-device shapes through every store move and recording,
    for each p2p recv, the concrete (shape, dtype) that crosses that
    channel — the contract ``MpmdExecutor``'s recv checks every arriving
    payload against.  A chunk runs once per input signature: the
    data-parallel replicas of a node reuse its output shapes."""

    def __init__(self, prog: CompiledProgram, gather_limit: Optional[int] = None) -> None:
        super().__init__(prog, gather_limit=gather_limit)
        self.p2p_shapes: dict[tuple[int, int], tuple] = {}
        self._meta_params = tree_map(
            lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t, prog.params or {})
        self._outs: dict[tuple, Any] = {}

    def replay(self, batch: dict[str, Any]) -> ScheduleReplay:
        from ..core import passes
        self.p2p_shapes, self._outs = {}, {}
        try:
            return super().replay(batch)
        finally:
            # a stash forward whose backward was served from the memo
            # leaves its (shape-only) graph behind
            table = passes.residual_graphs()
            with passes._GRAPHS_LOCK:
                for key in [k for k in table if isinstance(k[1], tuple)
                            and k[1][:1] == ("shape-oracle",)]:
                    del table[key]

    def _aval_args(self, node, t, store, feeds):
        # _gather_chunk_inputs, shape-only: multi-source cotangent slots
        # share one shape, so the summed value is its first contributor
        m = node.meta.get("n_inputs", 0)
        args: list = []
        for slot in range(m):
            key = (node.id, slot, t.device)
            if key in feeds:
                args.append(feeds[key])
                continue
            vals = [store[(e.src, e.src_out, t.device)]
                    for e in self._slot_edges.get((node.id, slot), ())
                    if (e.src, e.src_out, t.device) in store]
            args.append(vals[0] if vals else None)
        if "fwd_node" in node.meta:
            fwd = self.dag.nodes[node.meta["fwd_node"]]
            n_cots = node.meta.get("n_cots", fwd.n_outputs)
            m0 = node.meta["n_inputs"] - n_cots
            for slot in (list(node.meta.get("seed_slots", []))
                         + list(node.meta.get("zero_cot_slots", []))):
                s = fwd.out_specs[slot - m0]
                args[slot] = torch.empty(tuple(s.shape), dtype=getattr(torch, s.dtype),
                                         device="meta")
        return args

    def _exec_chunk(self, node, t, store, feeds, cons, grad_acc, grad_cnt,
                    losses, ledgers, gather_left, gather_consumers) -> None:
        from ..core import passes
        args = self._aval_args(node, t, store, feeds)
        bp = self._meta_params.get(node.bucket) if node.bucket else None
        sig = (node.id, tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args))
        outs = self._outs.get(sig)
        if outs is None:
            with torch.no_grad(), passes.microbatch(("shape-oracle", node.dims.get("MB", 0),
                                                     t.device)):
                outs = self._outs[sig] = node.fn(bp, *args)
        if node.meta.get("is_backward", False):
            out_vals, out_slots = list(outs[1:]), list(range(1, len(outs)))
        else:
            out_vals, out_slots = list(outs), list(range(len(outs)))
        discard = set(node.meta.get("discard_out_slots", []))
        for slot, val in zip(out_slots, out_vals):
            if slot in discard or val is None:
                continue
            key = (node.id, slot, t.device)
            if cons.get(key):
                store[key] = val
        self._release_inputs(node, t, store, cons, ledgers)
        super()._exec_chunk(node, t, store, feeds, cons, grad_acc, grad_cnt, losses,
                            ledgers, gather_left, gather_consumers)

    def _exec_recv(self, node, t, store, cons, ledgers) -> None:
        e = self._in_edges[node.id][0]
        src_dev = None
        for (s, d) in node.meta["pairs"]:
            if d == t.device:
                src_dev = s
        val = store.get((e.src, e.src_out, src_dev))
        if val is not None:
            store[(node.id, 0, t.device)] = val
            self.p2p_shapes[(node.id, t.device)] = (tuple(val.shape), val.dtype)
            pkey = (e.src, e.src_out, src_dev)
            cons[pkey] = cons.get(pkey, 1) - 1
            if cons[pkey] <= 0:
                store.pop(pkey, None)

    def _exec_collective(self, node, group_tasks, store, grad_acc, grad_cnt, reduced,
                         reduced_cnt, ledgers, cons, gather_left) -> None:
        # keep the walker's rate-limiter/reduction bookkeeping, but also
        # move shapes through pass-through ops so downstream chunks on
        # the same device can assemble their inputs
        if node.op in ("d2h", "h2d", "all_to_all", "broadcast") \
                or (node.op not in ("all_gather",) and node.payload != "grad"):
            for t in group_tasks:
                for e in self._in_edges[node.id]:
                    v = store.get((e.src, e.src_out, t.device))
                    if v is not None:
                        store[(node.id, 0, t.device)] = v
            for t in group_tasks:
                self._release_inputs(node, t, store, cons, ledgers)
        super()._exec_collective(node, group_tasks, store, grad_acc, grad_cnt, reduced,
                                 reduced_cnt, ledgers, cons, gather_left)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

@dataclass
class _Built:
    """Per batch signature: each rank's program (its witness order) and
    the replayed schedule facts the controller epilogue reads."""
    replay: ScheduleReplay
    orders: dict[int, list[tuple[int, str]]] = field(default_factory=dict)
    reduce_fold: dict[int, list[int]] = field(default_factory=dict)
    p2p_shapes: dict[tuple[int, int], tuple] = field(default_factory=dict)
    n_tasks: int = 0


@register_backend("mpmd")
class MpmdExecutor(_Lane):
    """Execute a ``CompiledProgram`` as N per-rank programs driven by N
    controller threads over an async message transport.

    ``transport``: "inproc" (default) or "tcp" (localhost sockets).
    ``timeout``: seconds any single transport wait may block before the
    run is declared desynced.
    ``signature_overrides``: {rank: signature-dict-or-bytes} replacing
    that rank's handshake payload — the fault-injection seam.
    ``handshake=False`` skips the startup signature exchange (only for
    harnesses that measure its cost separately).
    """

    def __init__(self, prog: CompiledProgram,
                 params: Optional[dict[str, Any]] = None, *,
                 transport: str = "inproc",
                 gather_limit: Optional[int] = None,
                 physical_devices: Optional[Sequence[int]] = None,
                 timeout: float = 60.0,
                 signature_overrides: Optional[dict] = None,
                 handshake: bool = True) -> None:
        # static rejection BEFORE any thread exists — the dynamic
        # analogue is a rendezvous deadlock across controllers
        validate_comm_order(prog.dag, prog.plan)
        self.prog = prog
        self.dag = prog.dag
        self.plan = prog.plan
        self.params = params if params is not None else prog.params
        self.timeout = float(timeout)
        self.devices = sorted(self.plan.devices)
        self.n = len(self.devices)
        if transport not in _TRANSPORTS:
            raise MpmdBackendError(
                f"unknown transport {transport!r}; available: {sorted(_TRANSPORTS)}")
        self.transport = _TRANSPORTS[transport]()
        # rank programs are independent: oversubscribing fewer devices is
        # allowed (rank r -> device r mod D), as in the JAX package
        self.physical_devices = place_ranks(self.n, physical_devices, self.device,
                                            MpmdBackendError)
        self._ref = Interpreter(prog, params=self.params, track_memory=False,
                                gather_limit=gather_limit)
        self._resolver = _ShapeOracle(prog, gather_limit=gather_limit)
        self._ranks: Optional[Ranks] = None
        self._built: dict[tuple, _Built] = {}
        self._gen = 0
        self.last_moved: dict[str, int] = {}
        self.last_rank_orders: dict[int, list[tuple[int, str]]] = {}
        if handshake:
            self._handshake(signature_overrides or {})

    # ------------------------------------------------------------ handshake
    def _handshake(self, overrides: dict) -> None:
        raw: dict[int, bytes] = {}
        for r in self.devices:
            o = overrides.get(r)
            if o is None:
                raw[r] = serialize_rank_signature(self.plan.rank_signature(r, self.dag))
            else:
                raw[r] = o if isinstance(o, bytes) else serialize_rank_signature(o)
        errors: list[str] = []
        lock = threading.Lock()

        def worker(pos: int, r: int) -> None:
            try:
                posts = self.transport.gather(("handshake", self._gen), pos, self.n,
                                              (r, raw[r]), self.timeout)
                sigs = {d: json.loads(b) for (d, b) in posts}
                errs = _pairwise_errors(r, sigs[r], sigs)
                if errs:
                    with lock:
                        errors.extend(errs)
            except MpmdTransportError as e:
                with lock:
                    errors.append(f"[PIPER025] rank {r}: {e}")
                self.transport.abort(f"handshake failed on rank {r}")

        threads = [threading.Thread(target=worker, args=(i, r), name=f"mpmd-hs{r}")
                   for i, r in enumerate(self.devices)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout + 5)
        self.transport.reset()
        if errors:
            uniq = sorted(set(errors))
            raise MpmdHandshakeError(
                "MPMD startup handshake failed — peer rank signatures "
                "disagree (PIPER025):\n  " + "\n  ".join(uniq[:8]))

    # ------------------------------------------------------------ build
    def _ensure_built(self, batch) -> _Built:
        key = self._sig(batch)
        if key not in self._built:
            self._built[key] = self._build(batch)
        return self._built[key]

    def _build(self, batch) -> _Built:
        replay = self._resolver.replay(batch)
        b = _Built(replay=replay, p2p_shapes=dict(self._resolver.p2p_shapes),
                   n_tasks=sum(p.n_tasks() for p in self.plan.device_plans.values()))
        # grad-reduce fold order: the interpreter advances a collective's
        # group tasks consecutively ([t] + peers), so the run of same-nid
        # ROLE_COLL entries in exec_order IS its member fold order
        grad_nids = {n.id for n in self.dag.nodes.values()
                     if n.is_comm and n.payload == "grad"
                     and n.op in ("all_reduce", "reduce_scatter")}
        for (nid, dev, role) in replay.exec_order:
            if role == ROLE_COLL and nid in grad_nids:
                b.reduce_fold.setdefault(nid, []).append(dev)
        b.orders = self._rank_orders(replay)
        return b

    def _rank_orders(self, replay) -> dict[int, list[tuple[int, str]]]:
        """Deadlock-free per-rank orders (module docstring: the witness
        construction).  Greedy completion over the plan's task graph in
        replay order, under blocking-transport semantics:

          compute/coll   pinned to the replay projection — each waits
                         for its rank's previous compute/coll, so the
                         numerics-bearing order is exactly the
                         interpreter's
          send           completes once its ``Task.deps`` (the producer
                         chunk) ran — a non-blocking post may float
                         ahead of its replay slot
          recv           completes only after its paired send task
                         (``Task.deps`` already contains it)
          rendezvous     all members complete atomically, each member's
                         own prerequisites permitting

        The completion sequence is a feasible global interleaving, so
        its per-rank projections cannot deadlock when each rank runs
        them as one blocking chain."""
        keys = [k for k in replay.exec_order]
        tasks = {}
        for p in self.plan.device_plans.values():
            tasks.update(p.tasks)
        # pinned chain: non-p2p tasks in per-rank projection order
        pinned: dict[tuple, tuple] = {}
        last: dict[int, tuple] = {}
        for k in keys:
            (nid, dev, role) = k
            if role in (ROLE_SEND, ROLE_RECV):
                continue
            if dev in last:
                pinned[k] = last[dev]
            last[dev] = k
        done: set[tuple] = set()
        pending = dict.fromkeys(keys)   # insertion-ordered set
        out: dict[int, list[tuple[int, str]]] = {r: [] for r in self.devices}

        def arrived(k) -> bool:
            t = tasks.get(k)
            peers = set(t.peers) if t is not None else set()
            if t is not None and any(d not in done for d in t.deps if d not in peers):
                return False
            return pinned.get(k) is None or pinned[k] in done

        def solo_ready(k) -> bool:
            t = tasks.get(k)
            if t is not None and any(d not in done for d in t.deps):
                return False
            return pinned.get(k) is None or pinned[k] in done

        def finish(k) -> None:
            done.add(k)
            pending.pop(k, None)
            out[k[1]].append((k[0], k[2]))

        while pending:
            progressed = False
            for k in list(pending):
                role = k[2]
                if role == ROLE_COLL:
                    t = tasks.get(k)
                    cohort = [k] + [p for p in (t.peers if t else []) if p in pending]
                    if all(arrived(m) for m in cohort):
                        for m in cohort:
                            finish(m)
                        progressed = True
                elif solo_ready(k):
                    finish(k)
                    progressed = True
                if progressed:
                    break
            if not progressed:
                stuck = ", ".join(map(str, list(pending)[:6]))
                raise MpmdBackendError(
                    "no feasible blocking execution of this plan — "
                    f"{len(pending)} task(s) unreachable under "
                    f"transport semantics (first: {stuck}); the static "
                    "verifier should have rejected this schedule "
                    "(PIPER001)")
        return out

    # ------------------------------------------------------------ one rank
    def _run_rank(self, r: int, b: _Built, st: RankState, ranks: Ranks) -> list:
        """Rank r's program, in its witness order, on the caller's
        (this thread's) stream.  Returns the (node, role) order run."""
        dag, params = self.dag, self.params_on(ranks.dev[r])
        ran = []
        for (nid, role) in b.orders[r]:
            node = dag.nodes[nid]
            ran.append((nid, role))
            if role == ROLE_COMPUTE:
                run_chunk(dag, self._ref, node, st, params)
            elif role == ROLE_SEND:
                self._send(r, node, st, ranks)
            elif role == ROLE_RECV:
                self._recv(r, node, st, ranks, b)
            elif node.op == "all_gather" and node.payload == "param":
                self._param_gather(r, node, st, ranks, params)
            elif node.op in ("all_reduce", "reduce_scatter") and node.payload == "grad":
                self._grad_reduce(r, node, st, ranks, b)
            elif node.op == "all_to_all":
                self._a2a(r, node, st, ranks)
            else:                   # d2h / h2d / broadcast / generic
                passthrough(self._ref, node, st)
        return ran

    def _send(self, r, node, st, ranks) -> None:
        e_in = self._ref._in_edges[node.id]
        assert len(e_in) == 1, f"p2p with {len(e_in)} inputs"
        key = (e_in[0].src, e_in[0].src_out)
        val = st.store[key]
        dsts = [d for (s, d) in node.meta["pairs"] if s == r]
        for d in dsts:
            self.transport.send(("p2p", self._gen, node.id, r, d), val, ranks, r)
        # the sender's consumers of this value include one per pair
        st.cons[key] = st.cons.get(key, len(dsts)) - len(dsts)
        if st.cons[key] <= 0:
            st.store.pop(key, None)

    def _recv(self, r, node, st, ranks, b) -> None:
        src = None
        for (s, d) in node.meta["pairs"]:
            if d == r:
                src = s             # last match, as Interpreter._exec_recv
        if src is None:
            return
        wire = b.p2p_shapes.get((node.id, r))
        if wire is None:
            spec = self._ref._in_edges[node.id][0].spec
            wire = (tuple(spec.shape), getattr(torch, spec.dtype))
        shape, dt = tuple(wire[0]), wire[1]
        v = self.transport.recv(("p2p", self._gen, node.id, src, r), self.timeout, ranks, r)
        if v is not None and (tuple(v.shape) != shape or v.dtype != dt):
            raise MpmdTransportError(
                f"p2p payload on channel rank {src} -> rank {r} (node {node.id}) arrived "
                f"as {dtype_name(v.dtype)}{list(v.shape)} but the receiver was wired for "
                f"{dtype_name(dt)}{list(shape)}")
        st.moved["p2p"] += tree_bytes(v)
        if st.cons.get((node.id, 0)):
            st.store[(node.id, 0)] = v

    def _group_of(self, node) -> list[int]:
        return sorted(set(node.group or node.devices))

    def _param_gather(self, r, node, st, ranks, params) -> None:
        buckets = node.meta.get("buckets") or [node.meta["bucket"]]
        group = self._group_of(node)
        g = len(group)
        if g <= 1:
            st.gathered[node.id] = {b: params[b] for b in buckets}
            return
        # fused buckets cross the wire as ONE concatenated byte payload
        total = sum(tree_bytes(params[b]) for b in buckets)
        chunk = -(-total // g)      # ceil: pad to g equal shards
        pos = group.index(r)
        shard = _shard_bytes([params[b] for b in buckets], pos * chunk, (pos + 1) * chunk)
        parts = self.transport.gather(("gather", self._gen, node.id), pos, g, shard,
                                      self.timeout, ranks, r,
                                      want=[i for i in range(g) if i != pos])
        parts[pos] = shard
        st.moved["gather"] += chunk * (g - 1)
        full = torch.cat(parts)[:total]
        st.gathered[node.id] = _split_buckets(full, [(b, _recipe(params[b])) for b in buckets])

    def _grad_reduce(self, r, node, st, ranks, b) -> None:
        group = self._group_of(node)
        g = len(group)
        pos = group.index(r)
        members = grad_members(node)
        # which member buckets THIS rank contributes is known locally
        contrib = {bkt: (st.grad_cnt[bkt], st.grad_acc[bkt])
                   for bkt, _acc in members if bkt in st.grad_acc}
        owner = pos == 0            # the group's lowest rank folds and records
        posts = self.transport.gather(("reduce", self._gen, node.id), pos, g, (r, contrib),
                                      self.timeout, ranks, r,
                                      want=[i for i in range(g) if i != pos] if owner else [])
        if owner:
            posts[pos] = (r, contrib)
            by_dev = {d: data for (d, data) in posts}
            st.moved["reduce"] += sum(tree_bytes(t) for (d, data) in posts if d != r
                                      for (_c, t) in data.values())
            fold = b.reduce_fold.get(node.id) or group
            for bkt, accumulated in members:
                xs, cnts = [], []
                for d in fold:
                    if bkt in by_dev.get(d, {}):
                        c, t = by_dev[d][bkt]
                        xs.append(t)
                        cnts.append(c)
                if not xs:
                    continue        # no contributions yet (mirrors the interpreter)
                # the owner keeps the running reduced sum: per bucket, its
                # folds come in schedule order
                keep_reduced(st, bkt, accumulated,
                             tree_map(lambda *ls: fold_mean(list(ls), cnts), *xs))
        for bkt in contrib:         # the grads were consumed by the reduction
            st.grad_acc.pop(bkt, None)
            st.grad_cnt.pop(bkt, None)

    def _a2a(self, r, node, st, ranks) -> None:
        e_in = self._ref._in_edges[node.id]
        assert len(e_in) == 1, f"a2a with {len(e_in)} inputs"
        val = st.store.get((e_in[0].src, e_in[0].src_out))
        group = self._group_of(node)
        g = len(group)
        if g > 1:
            # dispatch + return round trip: this rank's block crosses the
            # transport and comes back (identity values)
            pos = group.index(r)
            val = self.transport.gather(("a2a", self._gen, node.id), pos, g, val,
                                        self.timeout, ranks, r, want=[pos])[pos]
            st.moved["all_to_all"] += tree_bytes(val)
        if val is not None and st.cons.get((node.id, 0)):
            st.store[(node.id, 0)] = val
        release_inputs(self._ref, node, st)

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, b: _Built, batch):
        """One multi-controller step: N threads each run their rank's
        program on their rank's stream; any rank failure poisons the
        transport so peers fail fast instead of hanging."""
        ranks = self._rank_streams()
        if self.device.type == "cuda":
            _prebuild_kernels()
        self._gen += 1
        self.transport.reset()
        self._ref.params = self.params
        ranks.begin()
        states = new_rank_states(self._ref, ranks, self._ref._resolve_inputs(batch))
        ran: dict[int, list] = {}
        errors: dict[int, BaseException] = {}

        def worker(r: int) -> None:
            try:
                dev = ranks.dev[r]
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()), ranks.ctx(r):
                    ran[r] = self._run_rank(r, b, states[r], ranks)
            except BaseException as e:  # recorded, re-raised by the controller
                errors[r] = e
                self.transport.abort(f"rank {r} failed: {e}")

        threads = [threading.Thread(target=worker, args=(r,), name=f"mpmd-rank{r}")
                   for r in self.devices]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.timeout + 30
        for t in threads:
            t.join(max(0.1, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            self.transport.abort("controller join timeout")
            for t in threads:
                t.join(5)
            raise MpmdTransportError(
                "rank program(s) did not finish within the controller deadline — "
                "transport poisoned")
        ranks.end()
        if errors:
            raise sorted(errors.items())[0][1]
        self.last_moved = {k: sum(st.moved[k] for st in states.values())
                           for k in ("p2p", "gather", "reduce", "all_to_all")}
        self.last_rank_orders = ran
        return states

    # ------------------------------------------------------------ run
    def run(self, batch: dict[str, Any]) -> RunResult:
        b = self._ensure_built(batch)
        states = self._dispatch(b, batch)
        loss = mean_loss(b.replay, lambda nid, slot, d: states[d].loss[(nid, slot)], self.device)
        grads = final_grads(b.replay, states, self.device)
        return RunResult(
            loss=loss, grads=grads, ledgers={}, exec_order=list(b.replay.exec_order),
            stats={"backend": "mpmd", "tasks": b.n_tasks,
                   "losses": len(b.replay.loss_order), "devices": self.n,
                   "transport": self.transport.name,
                   "bytes_moved": dict(self.last_moved),
                   "rank_orders": {r: list(o) for r, o in self.last_rank_orders.items()}})

    # ------------------------------------------------------------ protocol
    @classmethod
    def compile(cls, prog: CompiledProgram,
                params: Optional[dict[str, Any]] = None, *,
                physical_devices: Optional[Sequence[int]] = None,
                **opts) -> "MpmdExecutor":
        return cls(prog, params, physical_devices=physical_devices, **opts)

    def measure(self, batch: dict[str, Any], reps: int = 3, warmup: int = 1) -> float:
        """Wall-clock seconds per multi-controller step (min over
        ``reps`` after ``warmup`` steps; each step ends with a
        ``torch.cuda.synchronize()`` on the card): per-rank dispatch and
        transport waits, the real MPMD step's critical path."""
        if reps < 1:
            raise ValueError(f"measure needs reps >= 1, got {reps}")
        b = self._ensure_built(batch)

        def step() -> None:
            self._dispatch(b, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        for _ in range(max(warmup, 0)):
            step()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        return min(times)

    def trace_sizes(self, batch: dict[str, Any]) -> dict[int, int]:
        """Per-rank program size, in operations (chunks, sends, recvs and
        collective posts of the rank's witness order) — the acceptance
        metric: every rank's count must be strictly below the whole-mesh
        program's (``SpmdExecutor.trace_size``) for world >= 4."""
        b = self._ensure_built(batch)
        return {r: len(b.orders[r]) for r in self.devices}

    def close(self) -> None:
        self.transport.close()


def _prebuild_kernels() -> None:
    """Build (or load) the kernel library before any controller thread
    starts, when kernels are installed, so that no transport timeout
    covers an ``nvcc`` build."""
    from ..kernels import _build
    from ..models import layers
    if layers._IMPLS:
        _build.library()
