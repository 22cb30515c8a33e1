"""The port's micro-batcher, deep staging and JSON HTTP server
(``sert_tpu_torch/serving.py``).

- ``tests/test_serving_batch.py``'s seven tests and
  ``tests/test_serving_depth.py``'s three, on the port's searcher (on the
  CPU);
- payload parity: the port's server and the reference's, each on its own
  package's searcher over the same trained run (one log-linear, one LSE),
  answer the same requests with the same JSON, field for field: status
  codes and error messages equal, scores within 1e-5 (fp32 products
  summed in another order; these comparisons read 2e-7), names equal up
  to ties within that.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu import pipeline as ref_pipeline  # noqa: E402
from sert_tpu import recipes  # noqa: E402
from sert_tpu import serving as ref_serving  # noqa: E402
from sert_tpu_torch import pipeline  # noqa: E402
from sert_tpu_torch.data.assoc import Associations, EntityRegistry  # noqa: E402
from sert_tpu_torch.data.prepare import prepare  # noqa: E402
from sert_tpu_torch.data.synthetic import make_synthetic  # noqa: E402
from sert_tpu_torch.serving import EntitySearcher, make_http_server  # noqa: E402
from sert_tpu_torch.utils.config import (DataConfig, ModelConfig,  # noqa: E402
                                         RecipeConfig, ScoreConfig,
                                         TrainConfig)

SCORE_TOL = 1e-5


def _train(root, recipe, seed):
    col = recipes.tiny_spec(seed=seed).build()
    data, run = str(root / "data"), str(root / "run")
    ref_pipeline.prepare_collection(col, data, recipe)
    ref_pipeline.train_from_dir(recipe, data, run, resume=False)
    return recipe, col, data, run


@pytest.fixture(scope="module")
def loglinear_run(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("batchserve"),
                  recipes.tiny_recipe("loglinear"), seed=11)


@pytest.fixture(scope="module")
def lse_run(tmp_path_factory):
    recipe = recipes.tiny_recipe("lse")
    recipe = dataclasses.replace(recipe, score=dataclasses.replace(
        recipe.score, similarity="cosine"))
    return _train(tmp_path_factory.mktemp("lseserve"), recipe, seed=7)


@pytest.fixture(scope="module")
def searcher(loglinear_run):
    recipe, col, data, run = loglinear_run
    return EntitySearcher(recipe, data, run, k=5, device="cpu"), col


def _queries(col, n):
    topics = sorted(col.topics)
    return [col.topics[topics[i % len(topics)]] for i in range(n)]


def _slow_first_dispatch(s, poison_ids=None):
    """Wrap ``s._score``: the first (leader) dispatch sleeps 0.3 s after
    scoring so that others pile up behind it; a batch holding
    ``poison_ids`` raises. Returns (the release event, the real scorer)."""
    real = s._score
    release = threading.Event()

    def scorer(encoded):
        if poison_ids is not None and any(
                list(ids) == list(poison_ids) for ids in encoded.values()):
            raise RuntimeError("poisoned query")
        out = real(encoded)
        if not release.is_set():
            release.set()
            time.sleep(0.3)
        return out

    s._score = scorer
    return release, real


def _run_threads(threads, first_then_rest=None):
    if first_then_rest is not None:
        threads[0].start()
        first_then_rest.wait(timeout=5)
        rest = threads[1:]
    else:
        rest = threads
    for t in rest:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


# --- tests/test_serving_batch.py on the port ------------------------------

class TestMicroBatch:
    def test_single_request_still_one_dispatch(self, searcher):
        s, col = searcher
        base = dict(s.stats)
        hits = s.search(_queries(col, 1)[0])
        assert hits and len(hits) == 5
        assert s.stats["dispatches"] == base["dispatches"] + 1
        assert s.stats["batched_queries"] == base["batched_queries"] + 1

    def test_concurrent_requests_coalesce(self, searcher):
        s, col = searcher
        texts = _queries(col, 16)
        serial = [s.search(t) for t in texts]
        release, real = _slow_first_dispatch(s)
        base = dict(s.stats)
        results = [None] * 16
        try:
            def worker(i):
                results[i] = s.search(texts[i])
            _run_threads([threading.Thread(target=worker, args=(i,))
                          for i in range(16)], release)
        finally:
            s._score = real
        d = s.stats["dispatches"] - base["dispatches"]
        q = s.stats["batched_queries"] - base["batched_queries"]
        assert q == 16
        assert d <= 4
        assert s.stats["max_batch"] >= 8
        for got, want in zip(results, serial):
            assert got == want

    def test_per_request_k_inside_shared_batch(self, searcher):
        s, col = searcher
        text = _queries(col, 1)[0]
        got = {}
        barrier = threading.Barrier(2)

        def worker(k):
            barrier.wait()
            got[k] = s.search(text, k=k)

        _run_threads([threading.Thread(target=worker, args=(k,))
                      for k in (2, 7)])
        assert len(got[2]) == 2 and len(got[7]) == 7
        assert got[7][:2] == got[2]

    def test_search_many_oov_placeholders(self, searcher):
        s, col = searcher
        text = _queries(col, 1)[0]
        out = s.search_many(["zzzunknownzzz", text, ""])
        assert out[0] is None and out[2] is None
        assert out[1] == s.search(text)
        assert s.search_many(["zzzunknownzzz"]) == [None]

    def test_error_propagates_to_all_waiters(self, searcher):
        s, col = searcher
        texts = _queries(col, 4)
        real = s._score

        def boom(encoded):
            raise RuntimeError("injected engine failure")

        s._score = boom
        errs = []
        try:
            def worker(i):
                try:
                    s.search(texts[i])
                except RuntimeError as e:
                    errs.append(str(e))
            _run_threads([threading.Thread(target=worker, args=(i,))
                          for i in range(4)])
        finally:
            s._score = real
        assert len(errs) == 4 and all("injected" in e for e in errs)
        assert s.search(texts[0])

    def test_http_concurrent_clients_coalesce(self, searcher):
        """12 HTTP clients, the first one's dispatch held for 0.3 s so that
        the other 11 provably pile up behind it: fewer engine calls than
        clients, each answer the serial one."""
        s, col = searcher
        texts = _queries(col, 12)
        serial = [s.search(t, k=3) for t in texts]
        server = make_http_server(s)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        release, real = _slow_first_dispatch(s)
        base = dict(s.stats)
        payloads = [None] * 12
        try:
            def client(i):
                q = urllib.parse.quote(texts[i])
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/search?q={q}&k=3",
                        timeout=30) as r:
                    payloads[i] = json.loads(r.read())
            _run_threads([threading.Thread(target=client, args=(i,))
                          for i in range(12)], release)
        finally:
            s._score = real
            server.shutdown()
            server.server_close()
        assert all(p is not None and len(p["results"]) == 3
                   for p in payloads)
        for p, want in zip(payloads, serial):
            assert [(r["entity"], r["score"]) for r in p["results"]] == want
        d = s.stats["dispatches"] - base["dispatches"]
        q = s.stats["batched_queries"] - base["batched_queries"]
        assert q == 12
        assert d < 12

    def test_batch_failure_isolated_per_request(self, searcher):
        s, col = searcher
        texts = _queries(col, 6)
        poison = texts[0]
        serial = [s.search(t) for t in texts[1:]]
        release, real = _slow_first_dispatch(s, s.encode(poison))
        results, errors = {}, {}
        try:
            def worker(i, text):
                try:
                    results[i] = s.search(text)
                except RuntimeError as e:
                    errors[i] = str(e)
            _run_threads([threading.Thread(target=worker, args=(i, t))
                          for i, t in enumerate([texts[1]] + texts)],
                         release)
        finally:
            s._score = real
        assert list(errors.values()) == ["poisoned query"]
        assert 1 in errors
        for i, want in [(0, serial[0]), (2, serial[0])] + \
                       [(i + 1, serial[i - 1]) for i in range(2, 6)]:
            assert results[i] == want, i
        assert s.search(texts[1])


def test_server_queues_a_burst_of_connects(searcher):
    """The listen backlog holds a burst of concurrent clients: 32 connects
    complete while no request is being accepted. (socketserver's backlog
    of 5 drops the SYNs past the sixth, and each client then retries after
    a second.)"""
    import socket
    s, _ = searcher
    server = make_http_server(s)
    conns = []
    try:
        for _ in range(32):
            conns.append(socket.create_connection(server.server_address,
                                                  timeout=0.5))
    finally:
        for c in conns:
            c.close()
        server.server_close()
    assert len(conns) == 32


# --- tests/test_serving_depth.py on the port ------------------------------

DEEP_E = 1200


@pytest.fixture(scope="module")
def deep_run(tmp_path_factory):
    """A log-linear run over 1200 entities, prepared and trained by the
    port on the CPU."""
    root = tmp_path_factory.mktemp("deepserve")
    col = make_synthetic(num_entities=DEEP_E, vocab_size=600,
                         docs_per_entity=1, doc_len=24, num_topics=4, seed=3)
    reg = EntityRegistry(col.entities)
    assoc = Associations()
    for d, es in col.doc_entities.items():
        for e in es:
            assoc.add(d, reg.id(e))
    data = str(root / "data")
    dcfg = DataConfig(window_size=6, vocab_min_count=1)
    prepare(col.docs, assoc, reg, data, dcfg)
    recipe = RecipeConfig(
        name="deep", data=dcfg,
        model=ModelConfig(model="loglinear", vocab_size=0,
                          num_entities=DEEP_E, word_dim=16),
        train=TrainConfig(batch_size=256, num_epochs=1, learning_rate=5e-3,
                          log_every_steps=0),
        score=ScoreConfig(top_k=100))
    run = str(root / "run")
    pipeline.train_from_dir(recipe, data, run, resume=False, device="cpu")
    return recipe, data, run, col


class TestDeepStaging:
    def test_constructor_k_stages_depth_1000(self, deep_run):
        recipe, data, run, col = deep_run
        s = EntitySearcher(recipe, data, run, k=1000, device="cpu")
        assert s.k_max == 1000
        hits = s.search(col.topics[sorted(col.topics)[0]])
        assert hits is not None and len(hits) == 1000
        scores = [h[1] for h in hits]
        assert scores == sorted(scores, reverse=True)
        assert len({h[0] for h in hits}) == 1000

    def test_recipe_top_k_raises_the_cap(self, deep_run):
        recipe, data, run, col = deep_run
        deep = dataclasses.replace(
            recipe, score=dataclasses.replace(recipe.score, top_k=1000))
        s = EntitySearcher(deep, data, run, k=5, device="cpu")
        assert s.k_max == 1000
        text = col.topics[sorted(col.topics)[0]]
        assert len(s.search(text)) == 5
        assert len(s.search(text, k=1000)) == 1000

    def test_cap_clamps_to_entity_count(self, deep_run):
        recipe, data, run, col = deep_run
        s = EntitySearcher(recipe, data, run, k=5000, device="cpu")
        assert s.k_max == DEEP_E
        text = col.topics[sorted(col.topics)[0]]
        assert len(s.search(text, k=5000)) == DEEP_E


# --- payload parity with the reference's server ---------------------------

class _Server:
    """A server in a thread; ``call`` returns (status, JSON body)."""

    def __init__(self, make, searcher):
        self.server = make(searcher, port=0)
        self.base = "http://127.0.0.1:%d" % self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def call(self, method, path, body=None):
        data = None
        if body is not None:
            data = body if isinstance(body, bytes) else json.dumps(
                body).encode()
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _same_results(got, want):
    """Two ranked result lists: ranks 1..n, scores within SCORE_TOL rank by
    rank and name by name; names may trade places only within a tie (a
    perfectly matched folded entity ties with the probe's top), and a name
    in one list only must tie with the other list's last."""
    assert [r["rank"] for r in got] == [r["rank"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=SCORE_TOL)
    g = {r["entity"]: r["score"] for r in got}
    w = {r["entity"]: r["score"] for r in want}
    for name in g.keys() & w.keys():
        assert abs(g[name] - w[name]) <= SCORE_TOL, name
    for name in g.keys() ^ w.keys():
        assert abs(g.get(name, w.get(name)) - min(w.values())) <= SCORE_TOL


def _same_payload(got, want):
    """Equal JSON, except ranked results (:func:`_same_results`)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for key in want:
            if key == "results":
                _same_results(got[key], want[key])
            else:
                _same_payload(got[key], want[key])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_payload(g, w)
    else:
        assert got == want


def _requests(col, lse):
    topics = [col.topics[t] for t in sorted(col.topics)]
    q = urllib.parse.quote(topics[0])
    reqs = [
        ("GET", "/healthz", None),
        ("GET", f"/search?q={q}&k=7", None),
        ("GET", f"/search?query={q}", None),
        ("GET", "/search?q=zzzunknownzzz", None),
        ("POST", "/search", {"query": topics[1], "k": 4}),
        ("POST", "/search", {"q": topics[2]}),
        ("POST", "/search", {"queries": topics[:5] + ["zzzunknownzzz"],
                             "k": 6}),
        ("POST", "/search", {"query": topics[3], "k": 10 ** 6}),
        ("POST", "/search", {"query": topics[3], "k": 0}),
        # 400s
        ("GET", "/search", None),
        ("GET", f"/search?q={q}&k=abc", None),
        ("POST", "/search", b"{not json"),
        ("POST", "/search", {"query": topics[0], "k": 2.5}),
        ("POST", "/search", {"query": topics[0], "k": True}),
        ("POST", "/search", {"queries": "not a list"}),
        ("POST", "/search", {"queries": [1, 2]}),
        ("POST", "/search", {}),
        ("POST", "/entities", {"entities": []}),
        ("POST", "/entities", {"entities": [{"name": "n", "text": 3}]}),
        ("POST", "/entities", {"entities": [{"name": "", "text": "x"}]}),
        ("POST", "/entities", {"entities": [{"name": "n", "text": "x"}],
                               "method": 5}),
        ("POST", "/entities", b"[1, 2"),
        ("POST", "/entities", {"entities": [{"name": "n",
                                             "text": "zzzunknownzzz"}]}),
        ("POST", "/entities", {"entities": [{"name": "n", "text": topics[0]}],
                               "method": "magic"}),
        # 404s
        ("GET", "/nope", None),
        ("POST", "/nope", {"query": topics[0]}),
    ]
    doc = col.docs[sorted(col.docs)[0]]
    reqs.append(("POST", "/entities",
                 {"entities": [{"name": "folded-a", "text": doc},
                               {"name": "folded-b", "text": topics[4]}]}))
    if lse:
        reqs += [
            ("POST", "/entities", {"entities": [{"name": "folded-g",
                                                 "text": doc}],
                                   "method": "gradient"}),
            ("POST", "/entities", {"entities": [{"name": "folded-a",
                                                 "text": doc}]}),
            ("GET", "/healthz", None),
            ("POST", "/search", {"queries": topics, "k": 10}),
            ("GET", f"/search?q={urllib.parse.quote(topics[4])}", None),
        ]
    return reqs


@pytest.mark.parametrize("which", ["loglinear", "lse"])
def test_payloads_equal_reference(which, loglinear_run, lse_run):
    recipe, col, data, run = {"loglinear": loglinear_run,
                              "lse": lse_run}[which]
    servers = {
        "ref": _Server(ref_serving.make_http_server,
                       ref_serving.EntitySearcher(recipe, data, run, k=5)),
        "port": _Server(make_http_server,
                        EntitySearcher(recipe, data, run, k=5,
                                       device="cpu"))}
    codes = []
    try:
        for method, path, body in _requests(col, which == "lse"):
            want = servers["ref"].call(method, path, body)
            got = servers["port"].call(method, path, body)
            assert got[0] == want[0], (method, path, body, got, want)
            _same_payload(got[1], want[1])
            codes.append(want[0])
    finally:
        for s in servers.values():
            s.close()
    assert {200, 400, 404} <= set(codes)
    if which == "lse":
        assert codes[-5:-3] == [200, 400]      # gradient fold-in, duplicate


def test_cli_serve_http_answers_and_folds_in(lse_run, tmp_path):
    """``python -m sert_tpu_torch serve --http 0 --device cpu`` binds an
    ephemeral port, says where on stderr, and serves /healthz, /search and
    POST /entities until it is stopped."""
    import os
    import re
    import subprocess
    import sys
    from sert_tpu.utils.config import save_config
    recipe, col, data, run = lse_run
    recipe_path = str(tmp_path / "recipe.json")
    save_config(recipe, recipe_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sert_tpu_torch", "serve", "--recipe",
         recipe_path, "--data", data, "--run-dir", run, "-k", "3",
         "--http", "0", "--device", "cpu"],
        cwd=repo, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    try:
        url = None
        for line in proc.stderr:
            found = re.search(r"ready: (http://\S+:\d+)", line)
            if found:
                url = found.group(1)
                break
        assert url, "the server never said it was ready"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["k_default"] == 3
        text = col.topics[sorted(col.topics)[0]]
        req = urllib.request.Request(
            url + "/entities", data=json.dumps({"entities": [
                {"name": "cli-new", "text": text}]}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read()) == {"added": 1, "extra_entities": 1}
        q = urllib.parse.quote(text)
        with urllib.request.urlopen(f"{url}/search?q={q}&k=5",
                                    timeout=60) as r:
            hits = json.loads(r.read())["results"]
        assert len(hits) == 5 and "cli-new" in [h["entity"] for h in hits]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stderr.close()
