"""The port's API surface against the JAX package's, by a static scan.

Every module of ``hyperdb_tpu/`` is parsed with ``ast`` beside its twin in
``hyperdb_tpu_torch/`` (and each module of ``hyperdb/`` beside its twin in
``hyperdb_torch/``); nothing is imported. A module pair's case compares:

- its top-level names: every public one (a dunder such as ``__version__``
  counts as public) and every private function or class; in an
  ``__init__.py`` also the names it imports;
- the parameter names, in order, of each function both modules define;
- each class's methods (public, dunder and private) and property setters,
  and the parameters of each method both classes define.

The port may add names and parameters only where ``ALLOWED`` says so; it
may never lose a name the JAX package has. Each entry of ``ALLOWED`` is one
difference, keyed as the failing case prints it, with its reason from
``ROADMAP.md`` §3 ("Known, deliberate differences"). To allow a new
deliberate difference, add its printed key and a one-line reason here and
to that section; ``test_allow_list_has_no_stale_entry`` fails on an entry
that no longer differs.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = (("hyperdb_tpu", "hyperdb_tpu_torch"), ("hyperdb", "hyperdb_torch"))

_DEVICE = "the port runs on the card unless the caller passes device='cpu'"
_N_VALID = "n_valid: rows of a padded query block that are real (the sharded surfaces' bucketing)"
_JIT = "a jit, shard_map or dynamic_update_slice program of JAX; the port runs torch ops eagerly"
_PALLAS = "a Pallas route switch; the port's kernel routes are chosen in ops/gmax.py and ops/l1.py"

ALLOWED = {
    # modules with no twin
    "hyperdb_tpu/ops/pallas_gmax.py: no twin":
        "Pallas kernels; the port's are csrc/gmax_wgmma.cu behind ops/gmax.py",
    "hyperdb_tpu/ops/pallas_l1.py: no twin":
        "Pallas kernels; the port's are csrc/l1.cu behind ops/l1.py",
    # the added trailing device parameters
    "hyperdb_tpu/core/db.py HyperDB.__init__: adds device": _DEVICE,
    "hyperdb_tpu/core/store.py VectorStore.__init__: adds device": _DEVICE,
    "hyperdb_tpu/index/__init__.py index_from_state: adds device": _DEVICE,
    "hyperdb_tpu/index/ivf.py IVFIndex.__init__: adds device": _DEVICE,
    "hyperdb_tpu/index/ivf.py IVFIndex.build: adds device": _DEVICE,
    "hyperdb_tpu/index/ivf.py IVFIndex.from_state: adds device": _DEVICE,
    "hyperdb_tpu/index/projscan.py ProjScanIndex.build: adds device": _DEVICE,
    "hyperdb_tpu/index/projscan.py ProjScanIndex.from_state: adds device": _DEVICE,
    "hyperdb_tpu/models/embedder.py select_embedder_for_corpus: adds device": _DEVICE,
    "hyperdb_tpu/models/embedder.py default_embedder: adds device": _DEVICE,
    "hyperdb_tpu/models/finetune.py finetune: adds device": _DEVICE,
    "hyperdb_tpu/models/minilm.py MiniLMEmbedder.from_local_assets: adds device": _DEVICE,
    "hyperdb_tpu/models/minilm.py MiniLMEmbedder.maybe_pretrained: adds device": _DEVICE,
    "hyperdb_tpu/models/train.py make_train_state: adds device": _DEVICE,
    "hyperdb_tpu/ops/ranking.py ranking_algorithm_sort: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py _single: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py dot_product: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py cosine_similarity: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py euclidean_metric: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py manhattan_distance: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py jaccard_similarity: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py pearson_correlation: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py hamming_distance: adds device": _DEVICE,
    "hyperdb/ranking_algorithm.py hyperDB_ranking_algorithm_sort: adds device": _DEVICE,
    "hyperdb_tpu/models/minilm.py MiniLMEmbedder.__init__: adds device, seed":
        _DEVICE + "; seed: params=None seeds its own torch.Generator",
    "hyperdb_tpu/parallel/mesh.py make_mesh: adds device, group":
        _DEVICE + "; group: the torch.distributed group of a multi-process mesh",
    "hyperdb_tpu/__main__.py _load_db: (path, metadata_keys) -> (path, device, metadata_keys)":
        "the CLI's --device choice",
    # n_valid on the sharded surfaces
    "hyperdb_tpu/parallel/sharded_db.py ShardedHyperDB.query_batch: adds n_valid": _N_VALID,
    "hyperdb_tpu/parallel/sharded_db.py ShardedHyperDB.query_batch_arrays: adds n_valid": _N_VALID,
    "hyperdb_tpu/parallel/multihost_serve.py MultihostQueryService.query_batch_arrays: adds n_valid":
        _N_VALID,
    # the JAX-only private helpers
    "hyperdb_tpu/ops/ranking.py: no function _use_pallas_gmax_f": _PALLAS,
    "hyperdb_tpu/ops/ranking.py: no function _use_pallas_l1": _PALLAS,
    "hyperdb_tpu/ops/quantized.py: no function _use_pallas_gmax": _PALLAS,
    "hyperdb_tpu/ops/quantized.py: no function _int8_grouped_topk_chunked":
        "the chunked int8 form; the port drops it on purpose (the int8 routes bound their epilogue instead)",
    "hyperdb_tpu/ops/quantized.py _rescore_groups: drops group_valid":
        "only JAX's _int8_grouped_topk_chunked passes group_valid",
    "hyperdb_tpu/index/projscan.py: no function _gmax_int8_xla":
        "the XLA form of gmax_int8; the port's stage A launches ops.gmax.gmax_int8 or its plain version",
    "hyperdb_tpu/index/projscan.py: no function _stage_a":
        _JIT + " (the port's stage A: _stage_a_on_kernel, _gmax_int8_groups16)",
    "hyperdb_tpu/index/projscan.py: no variable NEG_INF": "a constant only JAX's jitted stage A reads",
    "hyperdb_tpu/parallel/distributed.py: no function _sharded_topk_program": _JIT,
    "hyperdb_tpu/parallel/distributed.py: no function _sharded_topk_int8_program": _JIT,
    "hyperdb_tpu/parallel/sharded_db.py: no function _dus_rows_impl": _JIT,
    "hyperdb_tpu/parallel/sharded_db.py: no function _dus_vec_impl": _JIT,
    "hyperdb_tpu/parallel/sharded_db.py: no function _pearson_plane_impl": _JIT,
    "hyperdb_tpu/query/engine.py: no function _normalize_rows_dev": _JIT,
    "hyperdb_tpu/query/engine.py: no function _pearson_rows_dev": _JIT,
    "hyperdb_tpu/query/engine.py: no function _grouped_ok":
        "the port asks _grouped_group directly",
    "hyperdb_tpu/query/engine.py: no function _rank":
        "single queries go through _rank_block with a one-row block",
    "hyperdb_tpu/ops/metrics.py: no function _qv_dot": "public in the port as qv_dot",
    "hyperdb_tpu/ops/metrics.py: no function _row_sq_norms":
        "the store computes row_sq on the host (core/store.py)",
    "hyperdb_tpu/ops/metrics.py: no function dot_precision":
        "a jax.lax.Precision rule; the port scores f32 in true f32 by turning TF32 off at import",
    "hyperdb_tpu/core/store.py: no method VectorStore._padded_raw":
        "the port builds its planes a chunk of rows at a time (_build_plane, _over_row_chunks)",
    "hyperdb_tpu/core/store.py: no method VectorStore._padded_planes":
        "the port builds its planes a chunk of rows at a time (_build_plane, _over_row_chunks)",
    "hyperdb_tpu/core/store.py: no method VectorStore._materialize_plane":
        "the port builds its planes a chunk of rows at a time (_build_plane, _over_row_chunks)",
    "hyperdb_tpu/core/store.py: no method VectorStore._materialize_split_planes":
        "the port's split planes: _materialize_planes over plane_bounds",
    "hyperdb_tpu/parallel/multihost_serve.py: no method MultihostQueryService._run_block":
        "the port's ranks scan through _scan / _run_plane_query",
    "hyperdb_tpu/parallel/multihost_serve.py: no method MultihostQueryService._query_override_mh":
        "the port's key-filter override is _query_override",
    # the native host library
    "hyperdb_tpu/native/tokenizer.py build: drops force":
        "build() raises with the compiler's output; its file name hashes the sources, so no force",
    "hyperdb_tpu/native/tokenizer.py: no function _lib_path": "public in the port as library_path",
    "hyperdb_tpu/native/tokenizer.py: no function _load":
        "public in the port as load (it raises where JAX's returns None)",
    "hyperdb_tpu/native/tokenizer.py NativeWordTokenizer.__init__: drops lib":
        "the native classes load the library themselves and have no maybe_load",
    "hyperdb_tpu/native/tokenizer.py NativeWordPiece.__init__: (self, lib, handle) -> (self, vocab, unk_id)":
        "the native classes load the library themselves and have no maybe_load",
    "hyperdb_tpu/native/tokenizer.py: no method NativeWordTokenizer.maybe_load":
        "the native classes load the library themselves and have no maybe_load",
    "hyperdb_tpu/native/tokenizer.py: no method NativeWordPiece.maybe_load":
        "the native classes load the library themselves and have no maybe_load",
    # the encoder and the trainer
    "hyperdb_tpu/models/minilm.py: no method MiniLM.__call__": "nn.Module.forward, not __call__",
    "hyperdb_tpu/models/minilm.py: no method MiniLMLayer.__call__": "nn.Module.forward, not __call__",
    "hyperdb_tpu/models/minilm.py init_params: (seed, dtype, config) -> (config, seed, dtype)":
        "it returns a torch state dict (not a Flax model and tree), whose shapes need the config",
    "hyperdb_tpu/models/minilm.py load_hf_params: drops dtype":
        "it returns a NumPy tree for params_from_flax",
    "hyperdb_tpu/models/train.py param_spec: (path, leaf) -> (name, param)":
        "it works by name in the port's (out, in) layout",
    "hyperdb_tpu/utils/trace.py profiler_trace: (log_dir) -> (trace_path)":
        "it writes a torch Chrome trace",
    # the rest of the static scan's notes
    "hyperdb_tpu/parallel/multihost_serve.py build_sharded_rows: "
    "(mesh, local_rows, num_rows, axis, normalize, precision) -> "
    "(mesh, local_block, num_rows, axis, normalize, precision)":
        "it names its block local_block",
    "hyperdb_tpu/index/ivf.py _kmeans: (train, init, nlist, iters) -> (train, init, iters)":
        "it reads the list count from init",
    "hyperdb_tpu/core/db.py HyperDB._hashable_key: (self, query_input, top_k, "
    "return_similarities, filters, recency_bias, timestamp_key, metric, ann_percent) -> "
    "(self, query_input, *rest)":
        "*rest builds the same key",
    "hyperdb_tpu/core/db.py HyperDB._preload_into_memory: drops storage_file":
        "the argument is unused",
}


def _params(fn) -> list[str]:
    a = fn.args
    out = [x.arg for x in a.posonlyargs + a.args]
    if a.vararg:
        out.append("*" + a.vararg.arg)
    out += [x.arg for x in a.kwonlyargs]
    if a.kwarg:
        out.append("**" + a.kwarg.arg)
    return out


def _statements(body):
    """Top-level statements, looking inside ``if`` and ``try`` blocks."""
    for st in body:
        if isinstance(st, ast.If):
            yield from _statements(st.body)
            yield from _statements(st.orelse)
        elif isinstance(st, ast.Try):
            yield from _statements(st.body)
            for handler in st.handlers:
                yield from _statements(handler.body)
            yield from _statements(st.orelse)
            yield from _statements(st.finalbody)
        else:
            yield st


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__") and name.endswith("__"))


def _is_setter(fn) -> bool:
    return any(isinstance(d, ast.Attribute) and d.attr == "setter" for d in fn.decorator_list)


def _scan(path: Path) -> tuple[dict, dict, dict]:
    """(names: name -> kind, functions: name -> params,
    classes: name -> (methods: name -> params, setters))."""
    names, functions, classes = {}, {}, {}
    for st in _statements(ast.parse(path.read_text()).body):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[st.name] = "function"
            functions[st.name] = _params(st)
        elif isinstance(st, ast.ClassDef):
            names[st.name] = "class"
            methods, setters = {}, set()
            for item in st.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _is_setter(item):
                        setters.add(item.name)
                    else:
                        methods[item.name] = _params(item)
            classes[st.name] = (methods, setters)
        elif isinstance(st, (ast.Assign, ast.AnnAssign)):
            for target in st.targets if isinstance(st, ast.Assign) else [st.target]:
                for node in ast.walk(target):
                    if isinstance(node, ast.Name) and _public(node.id):
                        names.setdefault(node.id, "variable")
        elif isinstance(st, (ast.Import, ast.ImportFrom)) and path.name == "__init__.py":
            for alias in st.names:
                name = (alias.asname or alias.name).split(".")[0]
                if _public(name):
                    names.setdefault(name, "import")
    return names, functions, classes


def _param_change(want: list[str], got: list[str]) -> str:
    if got[: len(want)] == want:
        return "adds " + ", ".join(got[len(want):])
    if want[: len(got)] == got:
        return "drops " + ", ".join(want[len(got):])
    return f"({', '.join(want)}) -> ({', '.join(got)})"


def differences(jax_path: Path, port_path: Path) -> list[str]:
    """Every way the port module's surface falls short of the JAX module's."""
    tag = jax_path.relative_to(ROOT).as_posix()
    if not port_path.exists():
        return [f"{tag}: no twin"]
    j_names, j_funcs, j_classes = _scan(jax_path)
    p_names, p_funcs, p_classes = _scan(port_path)
    out = []
    for name, kind in j_names.items():
        if (_public(name) or kind in ("function", "class")) and name not in p_names:
            out.append(f"{tag}: no {kind} {name}")
    for name, params in j_funcs.items():
        if name in p_funcs and p_funcs[name] != params:
            out.append(f"{tag} {name}: {_param_change(params, p_funcs[name])}")
    for cls, (j_methods, j_setters) in j_classes.items():
        if cls not in p_classes:
            continue
        p_methods, p_setters = p_classes[cls]
        for name, params in j_methods.items():
            if name not in p_methods:
                out.append(f"{tag}: no method {cls}.{name}")
            elif p_methods[name] != params:
                out.append(f"{tag} {cls}.{name}: {_param_change(params, p_methods[name])}")
        for name in sorted(j_setters - p_setters):
            out.append(f"{tag}: no setter {cls}.{name}")
    return out


def _module_pairs() -> list[tuple[Path, Path]]:
    pairs = []
    for jax_pkg, port_pkg in PACKAGES:
        for path in sorted((ROOT / jax_pkg).rglob("*.py")):
            pairs.append((path, ROOT / port_pkg / path.relative_to(ROOT / jax_pkg)))
    return pairs


PAIRS = _module_pairs()


@pytest.mark.parametrize(
    "jax_path, port_path", PAIRS, ids=[p.relative_to(ROOT).as_posix() for p, _ in PAIRS]
)
def test_module_surface_matches_jax(jax_path, port_path):
    faults = [d for d in differences(jax_path, port_path) if d not in ALLOWED]
    assert not faults, "the port's surface differs from the JAX package's:\n" + "\n".join(faults)


def test_allow_list_has_no_stale_entry():
    found = {d for pair in PAIRS for d in differences(*pair)}
    stale = sorted(set(ALLOWED) - found)
    assert not stale, "allow-list entries that no longer differ:\n" + "\n".join(stale)
    assert all(reason.strip() for reason in ALLOWED.values())
