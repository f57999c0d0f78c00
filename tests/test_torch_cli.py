"""The port's CLI (``python -m hyperdb_tpu_torch``) against the JAX
package's, on the same JSONL corpus, with ``--device cpu``.

``build`` in each package gives the same ``stats``; ``query`` gives the
same documents and ids, scores within ``ATOL`` (the hash embedder's
vectors are bit-equal; two f32 scans sum them in different orders). A
checkpoint written by one package's CLI loads in the other's. ``serve
--sharded`` wraps the loaded DB in a ``ShardedHyperDB``; ``selectembed``,
which waits for the training part of the port, exits non-zero with a
message naming its ROADMAP item.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from hyperdb_tpu.__main__ import main as jax_main
from hyperdb_tpu_torch.__main__ import main

ATOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_main(argv):
    """The port's CLI on the CPU (``--device`` goes after the subcommand)."""
    return main([*argv, "--device", "cpu"])


@pytest.fixture
def corpus_file(tmp_path):
    path = tmp_path / "docs.jsonl"
    docs = [
        {"name": "ember", "info": {"type": "fire", "description": "sleeps near warm rocks"}},
        {"name": "tide", "info": {"type": "water", "description": "hunts in rivers"}},
        {"name": "gale", "info": {"type": "wind", "description": "rides mountain storms"}},
    ]
    path.write_text("\n".join(json.dumps(d) for d in docs))
    return str(path)


def _json_lines(out: str) -> list[dict]:
    # stdout carries results and the engine's INFO prints; keep the JSON
    return [json.loads(line) for line in out.strip().splitlines() if line.startswith("{")]


def _same_results(got, want):
    assert [(r["index"], r["document"]) for r in got] == [(r["index"], r["document"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                               rtol=0, atol=ATOL)


def test_build_stats_query(corpus_file, tmp_path, capsys):
    ckpt, jckpt = str(tmp_path / "corpus.ckpt"), str(tmp_path / "jax.ckpt")
    port_main(["build", "--input", corpus_file, "--output", ckpt, "--metadata-keys", "info.type"])
    jax_main(["build", "--input", corpus_file, "--output", jckpt, "--metadata-keys", "info.type"])
    capsys.readouterr()

    port_main(["stats", "--db", ckpt])
    stats = json.loads(capsys.readouterr().out)
    jax_main(["stats", "--db", jckpt])
    assert stats == json.loads(capsys.readouterr().out)
    assert stats["documents"] == 3 and stats["metadata_keys"] == ["info.type"]

    port_main(["query", "--db", ckpt, "--text", "sleeps near rocks", "-k", "2"])
    got = _json_lines(capsys.readouterr().out)
    jax_main(["query", "--db", jckpt, "--text", "sleeps near rocks", "-k", "2"])
    _same_results(got, _json_lines(capsys.readouterr().out))
    assert len(got) == 2 and got[0]["document"]["name"] == "ember"


def test_query_with_filters(corpus_file, tmp_path, capsys):
    ckpt = str(tmp_path / "c2.ckpt")
    port_main(["build", "--input", corpus_file, "--output", ckpt, "--metadata-keys", "info.type"])
    capsys.readouterr()
    argv = ["query", "--db", ckpt, "--text", "anything", "-k", "3",
            "--filters", '[["metadata", {"info.type": "water"}]]']
    port_main(argv)
    got = _json_lines(capsys.readouterr().out)
    jax_main(argv)  # the JAX CLI reads the port's checkpoint
    _same_results(got, _json_lines(capsys.readouterr().out))
    assert len(got) == 1 and got[0]["document"]["name"] == "tide"


def test_pickle_output_format(corpus_file, tmp_path, capsys):
    pkl = str(tmp_path / "corpus.pickle.gz")
    port_main(["build", "--input", corpus_file, "--output", pkl])
    capsys.readouterr()
    port_main(["stats", "--db", pkl])
    stats = json.loads(capsys.readouterr().out)
    jax_main(["stats", "--db", pkl])
    assert stats == json.loads(capsys.readouterr().out)
    assert stats["documents"] == 3


def test_checkpoints_cross_between_the_clis(corpus_file, tmp_path, capsys):
    """A checkpoint the port's CLI writes loads in the JAX CLI, and the
    reverse; each answers a query as the writer's own CLI does."""
    mine, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    port_main(["build", "--input", corpus_file, "--output", mine])
    jax_main(["build", "--input", corpus_file, "--output", theirs])
    capsys.readouterr()
    for path in (mine, theirs):
        port_main(["query", "--db", path, "--text", "rivers", "-k", "3"])
        got = _json_lines(capsys.readouterr().out)
        jax_main(["query", "--db", path, "--text", "rivers", "-k", "3"])
        _same_results(got, _json_lines(capsys.readouterr().out))
        assert got[0]["document"]["name"] == "tide"


def test_serve_warmup_metrics_parsing(corpus_file, tmp_path, capsys, monkeypatch):
    """--warmup-metrics tolerates spaces and validates names up front with a
    clear error; text warmup uses the first metric listed."""
    ckpt = str(tmp_path / "c3.ckpt")
    port_main(["build", "--input", corpus_file, "--output", ckpt])
    capsys.readouterr()
    with pytest.raises(SystemExit, match="bogus"):
        port_main(["serve", "--db", ckpt, "--warmup", "--warmup-metrics", "cosine_similarity,bogus"])

    seen = {}
    from hyperdb_tpu_torch.core.db import HyperDB

    import hyperdb_tpu_torch.server as _server

    monkeypatch.setattr(HyperDB, "warmup", lambda self, **kw: seen.update(kw))
    monkeypatch.setattr(_server, "serve", lambda db, **kw: 0)
    port_main(["serve", "--db", ckpt, "--warmup", "--warmup-metrics",
               "cosine_similarity, dot_product", "--warmup-text", "4"])
    assert seen["metric"] == ("cosine_similarity", "dot_product")
    assert seen["max_batch"] == 256 and seen["text_max_batch"] == 4


def test_selectembed_waits_for_the_training_port(tmp_path):
    """`selectembed` needs the training package (ROADMAP queue 1, item 13):
    the port keeps the subcommand and exits non-zero saying so."""
    path = tmp_path / "corpus.jsonl"
    path.write_text(json.dumps({"text": "a few words"}) + "\n")
    with pytest.raises(SystemExit, match="item 13") as exc:
        main(["selectembed", "--input", str(path), "--max-docs", "40"])
    assert exc.value.code != 0


def test_serve_sharded_waits_for_the_multi_device_port(corpus_file, tmp_path, capsys, monkeypatch):
    """`serve --sharded` (the multi-device port is here now) serves the
    checkpoint through a ShardedHyperDB over one shard of the DB's device,
    as the JAX CLI wraps its DB over a mesh of every device; the wrapper
    answers as the DB it wraps."""
    from hyperdb_tpu_torch import server as server_mod
    from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

    ckpt = str(tmp_path / "c4.ckpt")
    port_main(["build", "--input", corpus_file, "--output", ckpt])
    seen = {}
    monkeypatch.setattr(server_mod, "serve", lambda db, **kw: seen.update(db=db) or 0)
    assert port_main(["serve", "--db", ckpt, "--sharded"]) == 0
    sdb = seen["db"]
    assert isinstance(sdb, ShardedHyperDB) and sdb.mesh.shape["data"] == 1
    assert sdb.mesh.local_devices() == [sdb.db.device]
    got = sdb.query_batch(["hunts in rivers"], top_k=2)[0]
    want = sdb.db.query("hunts in rivers", top_k=2)
    assert [r[2] for r in got] == [r[2] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=0, atol=ATOL)


def test_serve_native_and_stdlib(corpus_file, tmp_path, capsys, monkeypatch):
    """`serve --native` and `serve --dynamic-batch-ms` start the port's
    front ends over the checkpoint; a client gets the DB's own answers."""
    from hyperdb_tpu_torch.client import HyperDBClient
    from hyperdb_tpu_torch.native.server import NativeQueryServer
    from hyperdb_tpu_torch.server import make_server

    ckpt = str(tmp_path / "c5.ckpt")
    port_main(["build", "--input", corpus_file, "--output", ckpt])
    answers = {}

    def ask(port):
        with HyperDBClient("127.0.0.1", port, timeout=30) as c:
            return c.query("hunts in rivers", top_k=2), c.stats()

    def native_forever(self):
        answers["native"] = ask(self.port)
        self.close()

    monkeypatch.setattr(NativeQueryServer, "serve_forever", native_forever)
    port_main(["serve", "--db", ckpt, "--native", "--port", "0", "--max-batch", "8"])

    import hyperdb_tpu_torch.server as _server

    def stdlib_serve(db, host, port, dynamic_batch_ms, wire_dtype):
        httpd = make_server(db, host, 0, dynamic_batch_ms=dynamic_batch_ms, wire_dtype=wire_dtype)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            answers["stdlib"] = ask(httpd.server_address[1])
        finally:
            httpd.shutdown()
            httpd.batcher.close()
            httpd.server_close()
            th.join(timeout=30)
        return 0

    monkeypatch.setattr(_server, "serve", stdlib_serve)
    port_main(["serve", "--db", ckpt, "--dynamic-batch-ms", "2"])
    (ids, scores), stats = answers["native"]
    (sids, sscores), sstats = answers["stdlib"]
    assert ids[0] == sids[0] == 1  # "tide"
    np.testing.assert_array_equal(ids, sids)
    np.testing.assert_allclose(scores, sscores, rtol=0, atol=1e-6)
    assert stats["native"]["queries"] == 1 and "native" not in sstats


def test_bench_prints_throughput(corpus_file, tmp_path, capsys):
    ckpt = str(tmp_path / "c6.ckpt")
    port_main(["build", "--input", corpus_file, "--output", ckpt])
    capsys.readouterr()
    port_main(["bench", "--db", ckpt, "--batch", "8", "--iters", "2", "-k", "2"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"qps", "ms_per_batch"} and out["qps"] > 0


def test_cli_top_k_alias(tmp_path):
    """README shows --top-k; the CLI accepts both spellings (subprocess,
    `python -m hyperdb_tpu_torch`, on the CPU)."""
    docs = tmp_path / "docs.jsonl"
    with open(docs, "w") as f:
        for i in range(5):
            f.write(json.dumps({"text": f"topic {i}"}) + "\n")
    out = str(tmp_path / "c.hdb")
    env = dict(os.environ, HYPERDB_DEFAULT_EMBEDDER="hash", PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "hyperdb_tpu_torch", "build", "--input", str(docs),
         "--output", out, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-500:]
    for flag in (["-k", "2"], ["--top-k", "2"]):
        r = subprocess.run(
            [sys.executable, "-m", "hyperdb_tpu_torch", "query", "--db", out,
             "--text", "topic 1", *flag, "--device", "cpu"],
            capture_output=True, text=True, env=env, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-500:]
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        assert len(lines) == 2
        assert json.loads(lines[0])["document"] == {"text": "topic 1"}
