"""Multi-process serving: an SPMD query service over a multi-process mesh.

Counterpart of ``hyperdb_tpu/parallel/multihost_serve.py`` on
``torch.distributed``. The single-process serving stack (server.py,
native/server.py) wraps one ``query_batch_arrays``. Across processes that is
not enough: every process must enter the same collective for each query, or
the group deadlocks. This module adds a host-side CONTROL CHANNEL that keeps
the processes in lockstep.

    rank 0 (leader)                        ranks 1..P-1 (followers)
    ---------------                        ------------------------
    HTTP front end (any) wraps             serve_forever():
    MultihostQueryService                    recv (q, k, metric) ---+
      .query_batch_arrays(q, ...)                                   |
        broadcast (q, k, metric) ----TCP--------------------------->+
        sharded_rank_top_k(...)   <--- same call, same args ----> sharded_rank_top_k(...)
        return the merged (ids, scores)                             discard its copy

Array surface: the unchunked exact scan (rows == documents, no filters or
recency). Queries are padded to pow2 batch buckets on the leader.

Full query surface: construct the leader's service with its host
``HyperDB`` (``host_db=``) and :meth:`MultihostQueryService.query_batch`
serves filters (metadata, sentence, skip_doc, key overrides), recency and
chunked corpora with the single-device engine's document-level semantics.
The data-dependent pieces ride the same control channel:

- filter masks and recency vectors are evaluated per document on the leader
  (it owns the documents), expanded to (n_pad,) row vectors and relayed ONCE
  per (filter spec, recency spec) as a cached PLANE; every process places
  its own shards of it, so the relay is paid per plane, not per query;
- a key filter's per-document override block is relayed the same way (its
  own row-sharded matrix, identity row -> document map);
- the chunk refill loop's data-dependent fetch depth is just MORE
  broadcast + collective steps: the leader deduplicates on the host
  (``parallel.sharded_db.dedup_doc_candidates``) and relays each deeper
  fetch.

Followers stay plain executors: they cache planes by token (leader and
followers evict in the same insertion order, so the caches never diverge)
and run whatever collective a message names. The process group's backend is
the caller's choice (``nccl`` on cards, ``gloo`` on the CPU or where ranks
share one card); the candidates' gather goes through it
(``parallel/distributed._all_gather``). The launchers in
``hyperdb_tpu_torch/tools/multihost_*dryrun.py`` run it across processes.
"""

from __future__ import annotations

import pickle
import socket
import struct
import time
from collections import OrderedDict

import numpy as np
import torch

from hyperdb_tpu_torch.parallel.distributed import (
    local_rows,
    shard_rows,
    sharded_rank_top_k,
    sharded_rank_top_k_int8,
)

_HDR = struct.Struct("<I")
_SENTINEL = {"op": "stop"}
_PLANE_CACHE_MAX = 8  # planes per process; leader and followers evict alike


def _send_msg(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_msg(sock: socket.socket):
    buf = b""
    while len(buf) < _HDR.size:
        chunk = sock.recv(_HDR.size - len(buf))
        if not chunk:
            raise ConnectionError("control channel closed")
        buf += chunk
    (n,) = _HDR.unpack(buf)
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            raise ConnectionError("control channel closed mid-message")
        parts.append(chunk)
        got += len(chunk)
    return pickle.loads(b"".join(parts))


def _pad_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _unit_block(q: np.ndarray) -> np.ndarray:
    """Unit-norm query rows in their own dtype (zero rows stay zero)."""
    q32 = np.asarray(q, dtype=np.float32)
    norms = np.linalg.norm(q32, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return (q32 / norms).astype(q.dtype)


class MultihostQueryService:
    """SPMD query service over a row-sharded multi-process corpus.

    Construct in EVERY process with the same arguments (after
    ``torch.distributed.init_process_group`` and a mesh carrying the group).
    The leader (rank 0) gets the serving surface, ``query_batch_arrays``
    with the contract of ``HyperDB.query_batch_arrays`` (unchunked subset),
    and relays each query block to the followers, which must be parked in
    :meth:`serve_forever`.

    ``rows`` is this process's :class:`~hyperdb_tpu_torch.parallel.
    distributed.ShardedRows` of the global (n_pad, d) matrix (build it with
    :func:`build_sharded_rows`: each process contributes only its rows),
    ``row_valid`` the matching validity mask, ``num_rows`` the true row
    count. ``control_port=0`` lets the leader bind a free port and share it
    with the followers over the process group.
    """

    def __init__(self, mesh, rows, row_valid, num_rows: int, axis: str = "data",
                 control_port: int = 0, leader_host: str = "127.0.0.1",
                 prenormalized: bool = True, host_db=None, chunk_slack: int = 4,
                 row_scales=None, ack_timeout_s: float | None = 60.0):
        self.mesh = mesh
        self.axis = axis
        # Every relayed message is acknowledged by each follower BEFORE it
        # enters the collective, with this deadline on the leader's socket.
        # A follower that closes raises at once (ConnectionError / EPIPE); one
        # that HANGS (alive, not reading) would otherwise block the leader in
        # sendall or in a collective it never joins. With the ack the leader
        # raises RuntimeError within the deadline and has NOT entered the
        # collective. None disables the ack.
        self.ack_timeout_s = ack_timeout_s
        self.rows = rows
        self.row_valid = row_valid
        # int8-pure serving: ``rows`` is the quantized matrix and
        # ``row_scales`` its per-row scales (build_sharded_rows(...,
        # precision="int8")); cosine needs prenormalized rows
        self.row_scales = row_scales
        self._int8 = rows.dtype == torch.int8
        if self._int8 and row_scales is None:
            raise ValueError("int8 rows need row_scales")
        self.num_rows = int(num_rows)
        self.n_pad = int(rows.shape[0])
        self.dim = int(rows.shape[1])
        self.prenormalized = prenormalized
        self.process_id = mesh.rank
        self._procs = mesh.world
        # the document-level surface: the leader's host HyperDB owns the
        # documents, filters and the row -> document map; followers pass None
        self.host_db = host_db
        self.chunk_slack = int(chunk_slack)
        self.collective_steps = 0
        if host_db is not None:
            self.row_docs = np.asarray(host_db.source_indices, dtype=np.int64)
            if self.row_docs.shape[0] != self.num_rows:
                raise ValueError(
                    f"host_db has {self.row_docs.shape[0]} chunk rows but "
                    f"num_rows={self.num_rows}: the sharded matrix must "
                    "hold one row per host chunk, in host order"
                )
            self._base_valid = np.arange(self.n_pad) < self.num_rows
        # plane caches: followers key device blocks by token, the leader
        # keys tokens by plane spec; both evict in the SAME insertion order
        # (bounded at _PLANE_CACHE_MAX), so a token the leader still holds
        # is live on every follower
        self._plane_cache: OrderedDict[int, tuple] = OrderedDict()
        self._plane_tokens: OrderedDict[tuple, int] = OrderedDict()
        self._next_token = 1
        self._conns: list[socket.socket] = []
        self._sock: socket.socket | None = None
        self.control_port = control_port
        if self._procs > 1:
            if self.process_id == 0:
                srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind((leader_host, control_port))
                srv.listen(self._procs)
                self.control_port = srv.getsockname()[1]
                self._listener = srv
            if control_port == 0:
                import torch.distributed as dist

                shared = [self.control_port]
                dist.broadcast_object_list(shared, src=0, group=mesh.group)
                self.control_port = int(shared[0])

    # -------------------------------------------------------------- wiring
    def accept_followers(self, timeout_s: float = 180.0) -> None:
        """Leader: block until every follower connected (call once). Raises
        socket.timeout if one never arrives, instead of hanging the group."""
        if self._procs == 1:
            return  # a group of one rank has no follower
        self._listener.settimeout(timeout_s)
        while len(self._conns) < self._procs - 1:
            conn, _ = self._listener.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # bounds sendall against a hung follower's full TCP buffer as
            # well as the per-message ack read
            conn.settimeout(self.ack_timeout_s)
            self._conns.append(conn)
        self._listener.settimeout(None)

    def _broadcast(self, msg) -> None:
        """Leader: relay one control message to every follower and wait for
        each one's 1-byte ack (deadline ``ack_timeout_s``) BEFORE the caller
        enters the collective. Raises RuntimeError naming the dead or hung
        follower instead of deadlocking the group."""
        for i, conn in enumerate(self._conns):
            try:
                _send_msg(conn, msg)
            except OSError as e:
                raise RuntimeError(
                    f"control-channel send to follower {i + 1} failed "
                    f"({e}); not entering the collective"
                ) from e
        if self.ack_timeout_s is None:
            return
        for i, conn in enumerate(self._conns):
            try:
                ack = conn.recv(1)
            except socket.timeout as e:
                raise RuntimeError(
                    f"follower {i + 1} did not acknowledge within "
                    f"{self.ack_timeout_s}s (hung follower?); not entering "
                    "the collective"
                ) from e
            except OSError as e:
                raise RuntimeError(
                    f"follower {i + 1} control channel failed ({e}); not "
                    "entering the collective"
                ) from e
            if not ack:
                raise RuntimeError(
                    f"follower {i + 1} closed the control channel; not "
                    "entering the collective"
                )

    def connect(self, port: int | None = None, leader_host: str = "127.0.0.1",
                retry_s: float = 120.0) -> None:
        """Follower: open the control channel to the leader, retrying while
        the leader's listener is not up yet."""
        deadline = time.time() + retry_s
        while True:
            try:
                self._sock = socket.create_connection(
                    (leader_host, port or self.control_port), timeout=30.0
                )
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.5)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)  # a follower waits for the leader as long as it takes

    # -------------------------------------------------------------- planes
    def _install_plane(self, token: int, n: int, mask_full, recency_full, rows_full) -> None:
        """Place THIS process's shards of one plane from the full host
        vectors (every process holds them: the leader computed them, the
        followers decoded the relay) and cache them by token. FIFO eviction
        at ``_PLANE_CACHE_MAX`` on every process, in message order, so the
        caches evict alike."""
        mask_dev = shard_rows(self.mesh, mask_full, self.axis)
        rec_dev = None if recency_full is None else shard_rows(self.mesh, recency_full, self.axis)
        rows_dev = None if rows_full is None else shard_rows(self.mesh, rows_full, self.axis)
        if len(self._plane_cache) >= _PLANE_CACHE_MAX:
            self._plane_cache.popitem(last=False)
        self._plane_cache[token] = (n, rows_dev, mask_dev, rec_dev)

    def _ensure_plane(self, spec, n: int, mask_full, recency_full, rows_full) -> int:
        """Leader: the token of a live plane for ``spec``, relaying and
        installing it on every process first if it is not cached."""
        tok = self._plane_tokens.get(spec)
        if tok is not None:
            return tok
        tok = self._next_token
        self._next_token += 1
        msg = {
            "op": "plane", "token": tok, "n": n,
            "mask": np.packbits(mask_full).tobytes(),
            "recency": (recency_full.astype(np.float32).tobytes()
                        if recency_full is not None else None),
            "rows": rows_full.astype(np.float32).tobytes() if rows_full is not None else None,
        }
        self._broadcast(msg)
        self._install_plane(tok, n, mask_full, recency_full, rows_full)
        if len(self._plane_tokens) >= _PLANE_CACHE_MAX:
            self._plane_tokens.popitem(last=False)
        self._plane_tokens[spec] = tok
        return tok

    def _scan(self, q: np.ndarray, k: int, metric: str, rows, mask, rec, override: bool):
        """One collective step, run alike by the leader and every follower.
        Cosine over unit rows becomes dot with a unit query (dot IS cosine
        there, and document-level recency adds to it directly); override
        planes are not unit rows and score their cosine in the scan."""
        if not override and metric == "cosine_similarity" and self.prenormalized:
            q, metric = _unit_block(q), "dot_product"
        q_t = torch.from_numpy(np.ascontiguousarray(q))
        if self._int8 and not override:
            # the quantized scan; override planes replace the corpus and stay f32
            if metric != "dot_product":
                raise ValueError(
                    "int8 multihost rows support cosine_similarity and "
                    f"dot_product only (got '{metric}')"
                )
            return sharded_rank_top_k_int8(
                self.mesh, q_t.float(), self.rows, self.row_scales, mask, k=k,
                recency=rec, axis=self.axis,
            )
        return sharded_rank_top_k(self.mesh, q_t, rows, mask, k=k, metric=metric,
                                  recency=rec, axis=self.axis)

    def _run_plane_query(self, q: np.ndarray, k: int, metric: str, token: int):
        if token == 0:
            return self._scan(q, k, metric, self.rows, self.row_valid, None, False)
        _, rows_ov, mask_dev, rec_dev = self._plane_cache[token]
        override = rows_ov is not None
        return self._scan(q, k, metric, rows_ov if override else self.rows,
                          mask_dev, rec_dev, override)

    def _relay_and_run(self, q: np.ndarray, k: int, metric: str, token: int):
        self._broadcast({
            "op": "query", "q": q.tobytes(), "dtype": q.dtype.str,
            "shape": q.shape, "k": k, "metric": metric, "token": token,
        })
        self.collective_steps += 1  # a refill shows as more than one step
        vals, idx = self._run_plane_query(q, k, metric, token)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _validate_metric(self, metric: str) -> None:
        """Leader-side check BEFORE any relay: a metric the executors would
        refuse must raise before a follower sees the message."""
        if not self._int8:
            return
        if metric not in ("cosine_similarity", "dot_product"):
            raise ValueError(
                "int8 multihost rows support cosine_similarity and "
                f"dot_product only (got '{metric}')"
            )
        if metric == "cosine_similarity" and not self.prenormalized:
            raise ValueError(
                "int8 cosine needs prenormalized rows (normalize before "
                "quantizing: build_sharded_rows(..., precision='int8'))"
            )

    # -------------------------------------------------------------- leader
    def query_batch_arrays(self, query_vectors, top_k: int = 5,
                           metric: str = "cosine_similarity", filters=None,
                           recency_bias: float = 0, timestamp_key=None,
                           ann_percent: int = 5, n_valid: int | None = None):
        """(B, d) -> ((B, k) int64 ids, (B, k) f32 scores), exact.

        Filters and recency go through :meth:`query_batch` when the leader
        holds ``host_db``; without it they raise, so a caller never gets
        unfiltered results. Rows are cut to the shortest when a filter
        leaves fewer than ``top_k`` documents for some query."""
        del ann_percent
        from hyperdb_tpu_torch.parallel.sharded_db import doc_rows_to_arrays

        if isinstance(query_vectors, torch.Tensor):
            query_vectors = query_vectors.float().cpu().numpy()
        if n_valid is not None:
            query_vectors = np.asarray(query_vectors)[:n_valid]
        if filters or recency_bias or timestamp_key:
            if self.host_db is None:
                raise ValueError(
                    "filters/recency on the multihost array surface need "
                    "the document-level service: construct the leader with "
                    "host_db= (the array surface relays the unfiltered scan)"
                )
            return doc_rows_to_arrays(self.query_batch(
                np.asarray(query_vectors), top_k=top_k, filters=filters, metric=metric,
                recency_bias=recency_bias, timestamp_key=timestamp_key,
            ))
        if self.process_id != 0:
            raise RuntimeError("query_batch_arrays is leader-only")
        self._validate_metric(metric)
        q = np.asarray(query_vectors)
        if q.dtype != np.float16:
            q = np.asarray(q, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"query block must be (B, {self.dim}); got {q.shape}")
        b_real = q.shape[0]
        b_pad = _pad_pow2(b_real)
        if b_pad != b_real:
            q = np.concatenate([q, np.repeat(q[:1], b_pad - b_real, axis=0)])
        k = min(int(top_k), self.num_rows)
        k_pad = min(_pad_pow2(k), self.n_pad)
        vals, idx = self._relay_and_run(q, k_pad, metric, 0)
        return (np.asarray(idx[:b_real, :k], dtype=np.int64),
                np.asarray(vals[:b_real, :k], dtype=np.float32))

    def query_batch(self, query_inputs, top_k: int = 5, filters=None,
                    metric: str = "cosine_similarity", return_similarities: bool = True,
                    recency_bias: float = 0, timestamp_key=None):
        """Document-level search over the multi-process mesh: filters,
        recency, key-filter overrides and chunked dedup + refill with the
        single-device engine's semantics (leader only; needs ``host_db``).
        Every data-dependent step (a new plane, each deeper refill) is one
        more relayed broadcast + collective."""
        from hyperdb_tpu_torch.parallel.sharded_db import (
            compute_filter_row_mask,
            dedup_doc_candidates,
            refill_depth,
        )
        from hyperdb_tpu_torch.query import engine as _engine
        from hyperdb_tpu_torch.query.filters import hashable_filters

        if self.process_id != 0:
            raise RuntimeError("query_batch is leader-only")
        self._validate_metric(metric)
        db = self.host_db
        if db is None:
            raise RuntimeError(
                "the full query surface needs the leader's host HyperDB: "
                "construct MultihostQueryService with host_db="
            )
        if isinstance(query_inputs, np.ndarray) and query_inputs.ndim == 2:
            q = np.asarray(query_inputs, dtype=np.float32)
        else:
            q = np.stack([
                _engine.generate_and_validate_query_vector(db, qi) for qi in query_inputs
            ]).astype(np.float32)
        if q.shape[1] != self.dim:
            raise ValueError(f"query block must be (B, {self.dim}); got {q.shape}")
        b_real = q.shape[0]
        b_pad = _pad_pow2(b_real)
        if b_pad != b_real:
            q = np.concatenate([q, np.repeat(q[:1], b_pad - b_real, axis=0)])

        row_mask, (doc_mask, override) = compute_filter_row_mask(
            db, filters, self._base_valid, self.row_docs, self.num_rows,
        )
        if override is not None:
            return self._query_override(
                q, doc_mask, override, top_k, metric, return_similarities,
                recency_bias, timestamp_key, filters,
            )[:b_real]
        if not row_mask[: self.num_rows].any():
            # filters emptied the corpus: empty rows and NO collective (the
            # followers see no message, so nothing deadlocks)
            return [[] for _ in range(b_real)]

        num_docs = len(db.documents)
        recency_full = None
        if recency_bias != 0:
            surviving = np.zeros(num_docs, dtype=bool)
            surviving[np.unique(self.row_docs[row_mask[: self.num_rows]])] = True
            dense = _engine.handle_timestamps(
                db, recency_bias, timestamp_key, np.flatnonzero(surviving)
            )
            recency_full = np.zeros(self.n_pad, dtype=np.float32)
            recency_full[: self.num_rows] = dense[self.row_docs]

        if filters is None and recency_full is None:
            token = 0  # the base plane: the padding-only mask, already placed
        else:
            token = self._ensure_plane(
                ("rows", hashable_filters(filters), float(recency_bias), timestamp_key),
                self.n_pad, row_mask, recency_full, None,
            )

        chunked = num_docs != self.num_rows
        k_fetch = (1 << max(0, top_k * self.chunk_slack - 1).bit_length()) if chunked else top_k
        k_fetch = min(k_fetch, self.n_pad)
        while True:
            vals, idx = self._relay_and_run(q, k_fetch, metric, token)
            results, need_refill = dedup_doc_candidates(
                vals, idx, self.row_docs, db.documents, top_k, k_fetch,
                self.num_rows, self.n_pad, return_similarities,
            )
            if not need_refill:
                return results[:b_real]
            k_fetch = refill_depth(k_fetch, top_k, db.split_info, self.n_pad)

    def _query_override(self, q, doc_mask, override, top_k, metric, return_similarities,
                        recency_bias, timestamp_key, filters):
        """Key-filter override scoring across processes: the per-document
        block is relayed once per filter spec as its own row-sharded plane
        (identity row -> document map, no dedup or refill)."""
        from hyperdb_tpu_torch.parallel.distributed import pad_rows_per_shard
        from hyperdb_tpu_torch.parallel.sharded_db import override_rows
        from hyperdb_tpu_torch.query import engine as _engine
        from hyperdb_tpu_torch.query.filters import hashable_filters

        db = self.host_db
        if not doc_mask.any():
            return [[] for _ in range(q.shape[0])]
        num_docs = len(db.documents)
        n_dev = self.mesh.shape[self.axis]
        n_ov = pad_rows_per_shard(num_docs, n_dev) * n_dev

        spec = ("override", hashable_filters(filters), float(recency_bias), timestamp_key)
        if spec in self._plane_tokens:
            token = self._plane_tokens[spec]
        else:
            rows_full = np.zeros((n_ov, self.dim), dtype=np.float32)
            rows_full[:num_docs] = np.asarray(override, dtype=np.float32)
            valid = np.zeros(n_ov, dtype=bool)
            valid[:num_docs] = doc_mask
            rec = None
            if recency_bias != 0:
                dense = _engine.handle_timestamps(
                    db, recency_bias, timestamp_key, np.flatnonzero(doc_mask)
                )
                rec = np.zeros(n_ov, dtype=np.float32)
                rec[:num_docs] = dense
            token = self._ensure_plane(spec, n_ov, valid, rec, rows_full)

        k = min(min(top_k, int(doc_mask.sum())), n_ov)
        vals, idx = self._relay_and_run(q, k, metric, token)
        return override_rows(vals, idx, num_docs, db.documents, top_k, return_similarities)

    # ------------------------------------------------------- stats surface
    # The attributes the HTTP front ends read, so the leader can be served
    # directly by NativeQueryServer / make_server over the whole group.
    @property
    def db(self):  # the host-db unwrap: the service is its own host surface
        return self

    def size(self, with_chunks=False, metadata_filter=None):
        del with_chunks, metadata_filter
        return self.num_rows

    @property
    def source_indices(self):
        return range(self.num_rows)  # rows == documents on the array surface

    ann_metric = "cosine"
    ann_index = None

    @property
    def device(self):
        return self.mesh.local_devices(self.axis)[0]

    def get_cache_size_and_info(self):
        return {"cache_info": {"hits": 0, "misses": 0, "maxsize": 0, "currsize": 0},
                "cache_memory_size": "0 bytes"}

    @property
    def stats(self):
        from hyperdb_tpu_torch.utils.trace import Stats

        if not hasattr(self, "_stats"):
            self._stats = Stats()
        return self._stats

    def close(self) -> None:
        if self.process_id == 0:
            for conn in self._conns:
                try:
                    _send_msg(conn, _SENTINEL)
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
            if self._procs > 1:
                self._listener.close()
        elif self._sock is not None:
            self._sock.close()
            self._sock = None

    # ------------------------------------------------------------ follower
    def serve_forever(self, max_msgs: int | None = None) -> None:
        """Follower loop: run the leader's collectives until the stop
        sentinel. Each message is acknowledged with one byte BEFORE it runs
        (the leader's liveness barrier). ``max_msgs`` returns after that
        many messages (a test hook: a follower that stops reading mid-stream
        stands for a hung host)."""
        if self.process_id == 0:
            raise RuntimeError("serve_forever is follower-only")
        if self._sock is None:
            raise RuntimeError("call connect() first")
        seen = 0
        while True:
            if max_msgs is not None and seen >= max_msgs:
                return
            msg = _recv_msg(self._sock)
            op = msg.get("op")
            if op == "stop":
                return
            try:
                self._sock.sendall(b"\x01")
            except OSError:
                return  # the leader is gone: nothing left to follow
            seen += 1
            if op == "plane":
                n = msg["n"]
                mask = np.unpackbits(np.frombuffer(msg["mask"], dtype=np.uint8), count=n).astype(bool)
                rec = (np.frombuffer(msg["recency"], dtype=np.float32)
                       if msg.get("recency") is not None else None)
                rows = None
                if msg.get("rows") is not None:
                    rows = np.frombuffer(msg["rows"], dtype=np.float32).reshape(n, self.dim)
                self._install_plane(msg["token"], n, mask, rec, rows)
                continue
            q = np.frombuffer(msg["q"], dtype=np.dtype(msg["dtype"])).reshape(msg["shape"])
            vals, idx = self._run_plane_query(q, msg["k"], msg["metric"], msg["token"])
            # read the merged candidates back, so this step's collective has
            # completed in this process before the next message
            vals.cpu(), idx.cpu()


def build_sharded_rows(mesh, local_block: np.ndarray, num_rows: int, axis: str = "data",
                       normalize: bool = True, precision: str = "f32"):
    """Place the global (n_pad, d) row matrix and its validity mask from
    each process's LOCAL row block (the multi-process ingest pattern: no
    process holds the whole corpus).

    ``local_block`` is this process's contiguous slice of the padded global
    matrix (every process passes the same ``num_rows``, the true row count
    before padding). Rows are L2-normalized locally when ``normalize``.
    Returns ``(rows, row_valid, n_pad)``, or with ``precision="int8"``
    (per-row symmetric quantization, local by construction)
    ``(rows_q, row_scales, row_valid, n_pad)``: normalize-then-quantize
    makes the quantized dot a (quantized) cosine."""
    local = np.asarray(local_block, dtype=np.float32)
    if normalize:
        norms = np.linalg.norm(local, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        local = local / norms
    start = mesh.rank * local.shape[0]
    valid_local = np.arange(start, start + local.shape[0]) < num_rows
    row_valid = local_rows(mesh, valid_local, axis)
    if precision == "int8":
        from hyperdb_tpu_torch.ops.quantized import quantize_rows

        q_local, s_local = quantize_rows(local)
        rows_q = local_rows(mesh, q_local, axis)
        return rows_q, local_rows(mesh, s_local, axis), row_valid, int(rows_q.shape[0])
    rows = local_rows(mesh, local, axis)
    return rows, row_valid, int(rows.shape[0])
