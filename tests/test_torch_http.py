"""The port's HTTP embedding modes and chat layer on the CPU, held against
the JAX package: both packages' ollama mode against one in-process fake
server (no network), the OpenAI and Gemini guards, the chat model
validators and ``get_llm``, an ollama-mode flat index through the port's
builder and searcher, and ``LeannChat.ask`` with the simulated LLM."""

import json
import sys
import threading
import zlib
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import leann_torch  # noqa: E402
import leann_tpu  # noqa: E402
from leann_torch import chat as t_chat  # noqa: E402
from leann_torch.embeddings import compute as t_compute  # noqa: E402
from leann_tpu import chat as j_chat  # noqa: E402
from leann_tpu.embeddings import compute as j_compute  # noqa: E402


class FakeOllama:
    """A programmable fake Ollama on 127.0.0.1 (tests/test_embedding_http.py's,
    with vectors seeded by the prompt's CRC-32): ``fail_counts`` maps a
    prompt to the failures served before it succeeds (-1: always fails)."""

    def __init__(self, models=("nomic-embed-text:latest", "all-minilm:l6-v2"), dim=8):
        self.models, self.dim = list(models), dim
        self.fail_counts, self.calls = {}, []
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/api/version":
                    self._json(200, {"version": "0.0-fake"})
                elif self.path == "/api/tags":
                    self._json(200, {"models": [{"name": m} for m in fake.models]})
                else:
                    self._json(404, {})

            def do_POST(self):
                req = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                prompt = req.get("prompt", "")
                fake.calls.append(prompt)
                left = fake.fail_counts.get(prompt, 0)
                if left == -1:
                    return self._json(500, {"error": "permanent"})
                if left > 0:
                    fake.fail_counts[prompt] = left - 1
                    return self._json(500, {"error": "transient"})
                if prompt == "wrong-width":
                    return self._json(200, {"embedding": [1.0] * (fake.dim + 1)})
                if prompt == "zero":
                    return self._json(200, {"embedding": [0.0] * fake.dim})
                rng = np.random.default_rng(zlib.crc32(prompt.encode()))
                self._json(200, {"embedding": rng.standard_normal(fake.dim).tolist()})

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.host = f"http://127.0.0.1:{self.server.server_port}"
        self.thread = threading.Thread(target=self.server.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture()
def fake():
    srv = FakeOllama()
    yield srv
    srv.close()


UNREACHABLE = "http://127.0.0.1:1"


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - both packages must fail alike
        return "raised", (type(e).__name__, str(e))


def _same(a, b):
    if a[0] == "ok" and b[0] == "ok" and isinstance(a[1], np.ndarray):
        return a[1].dtype == b[1].dtype and np.array_equal(a[1], b[1])
    return a == b


# name -> (texts, fail_counts, kwargs, expected outcome)
OLLAMA_CASES = {
    "basic": (["alpha", "beta"], {}, {}, "ok"),
    "versioned_name": (["alpha"], {}, {"model": "all-minilm"}, "ok"),
    "pull_hint": (["alpha"], {}, {"model": "no-such-model"}, "raised"),
    "unreachable": (["alpha"], {}, {"host": UNREACHABLE, "timeout": 1}, "raised"),
    "retried": (["flaky", "ok"], {"flaky": 2}, {}, "ok"),
    "zero_filled": (["dead", "ok"], {"dead": -1}, {}, "ok"),
    "all_failed": (["a", "b"], {"a": -1, "b": -1}, {}, "raised"),
    "truncated": (["x" * 20000, "y" * 7999], {}, {}, "ok"),
    "zero_norm": (["zero", "ok"], {}, {}, "ok"),
    "inconsistent_widths": (["ok", "wrong-width"], {}, {}, "raised"),
    "no_validation": (["alpha"], {}, {"model": "unlisted", "validate": False}, "ok"),
    "fewer_retries": (["flaky", "ok"], {"flaky": 1}, {"max_retries": 1}, "ok"),
}


@pytest.mark.parametrize("case", sorted(OLLAMA_CASES))
def test_ollama_embeddings_identical_to_jax(fake, case):
    texts, fails, kwargs, expect = OLLAMA_CASES[case]
    kwargs = dict(kwargs)
    model = kwargs.pop("model", "nomic-embed-text")
    kwargs.setdefault("host", fake.host)
    runs = []
    for mod in (j_compute, t_compute):
        fake.fail_counts, fake.calls = dict(fails), []
        runs.append((_outcome(lambda: mod._ollama_embeddings(texts, model, **kwargs)), list(fake.calls)))
    (want, want_calls), (got, got_calls) = runs
    assert _same(got, want) and got_calls == want_calls and got[0] == expect
    if expect == "ok":
        emb = got[1]
        assert emb.shape == (len(texts), fake.dim) and emb.dtype == np.float32
        norms = np.linalg.norm(emb, axis=1)
        assert np.all((np.abs(norms - 1) < 1e-5) | (norms == 0))
    if case == "zero_filled":
        assert np.array_equal(got[1][0], np.zeros(fake.dim, np.float32)) and got_calls.count("dead") == 3
    if case == "retried":
        assert got_calls.count("flaky") == 3 and np.linalg.norm(got[1][0]) > 0.5
    if case == "truncated":
        assert [len(c) for c in got_calls] == [8000, 7999]
    if case == "pull_hint":
        assert "ollama pull no-such-model" in got[1][1]
    if case == "unreachable":
        assert got[1][0] == "RuntimeError" and "Could not connect to Ollama" in got[1][1]


@pytest.mark.parametrize("model", ["nomic-embed-text", "all-minilm", "all-minilm:l6-v2", "minilm", "nope"])
def test_validate_ollama_model_identical_to_jax(fake, model):
    want = _outcome(lambda: j_compute.validate_ollama_model(model, host=fake.host))
    assert _outcome(lambda: t_compute.validate_ollama_model(model, host=fake.host)) == want


def test_compute_embeddings_dispatches_ollama(fake):
    texts = ["one text", "another text", ""]
    want = j_compute.compute_embeddings(texts, "nomic-embed-text", mode="ollama", host=fake.host)
    got = t_compute.compute_embeddings(texts, "nomic-embed-text", mode="ollama", host=fake.host, device="cpu")
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_openai_guards_match_jax(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    for texts in (["ok", "  "], ["ok", None], [""]):
        want = _outcome(lambda: j_compute._openai_embeddings(texts, "text-embedding-3-small"))
        got = _outcome(lambda: t_compute._openai_embeddings(texts, "text-embedding-3-small"))
        assert got == want and got[1][0] == "ValueError" and "empty/invalid" in got[1][1]
    want = _outcome(lambda: j_compute._openai_embeddings(["ok"], "text-embedding-3-small"))
    got = _outcome(lambda: t_compute._openai_embeddings(["ok"], "text-embedding-3-small"))
    assert got == want == ("raised", ("RuntimeError", "OPENAI_API_KEY environment variable not set"))
    # through the dispatch, which never falls back to the in-process encoder
    got = _outcome(lambda: t_compute.compute_embeddings(["ok"], "hash-tiny", mode="openai", device="cpu"))
    assert got == ("raised", ("RuntimeError", "OPENAI_API_KEY environment variable not set"))


def test_openai_and_gemini_need_their_package(monkeypatch):
    """With a key set, a missing ``openai`` (or ``google.genai``) package
    raises the JAX package's error; the package is imported only there."""
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.setitem(sys.modules, "openai", None)
    monkeypatch.setitem(sys.modules, "google.genai", None)
    monkeypatch.setattr(t_compute, "_openai_client", None)
    monkeypatch.setattr(j_compute, "_openai_client", None)
    for fn in (lambda m: m._openai_embeddings(["ok"], "text-embedding-3-small"),
               lambda m: m._gemini_embeddings(["ok"], "text-embedding-004")):
        want, got = _outcome(lambda: fn(j_compute)), _outcome(lambda: fn(t_compute))
        assert got == want and got[0] == "raised" and got[1][0] == "RuntimeError"


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="Unknown embedding mode"):
        t_compute.compute_embeddings(["x"], "hash-tiny", mode="nope", device="cpu")


# ---------------------------------------------------------------------------
# an ollama-mode index through the port's builder and searcher
# ---------------------------------------------------------------------------


_OLLAMA = {mod: mod._ollama_embeddings for mod in (t_compute, j_compute)}


def _to_host(monkeypatch, host):
    """Point both packages' ollama mode at ``host``: the builders and
    searchers call it with the mode's default host."""
    for mod, real in _OLLAMA.items():
        monkeypatch.setattr(mod, "_ollama_embeddings",
                            lambda texts, model, _real=real, **kw: _real(texts, model, **{**kw, "host": host}))


def test_ollama_index_searches_as_a_direct_flat_search(fake, tmp_path, monkeypatch):
    """A flat index built in the ollama mode stores the server's vectors (the
    JAX package's build stores the same), its search embeds the queries
    through the server and gives a flat search's labels and scores over
    those vectors; with the server gone it raises, and never falls back to
    the in-process encoder."""
    from leann_torch.ops.distance import flat_search, pad_features

    _to_host(monkeypatch, fake.host)
    texts = [f"passage {i} about topic {i % 7} and item {i * 13 % 29}" for i in range(60)]
    queries = [f"topic {i} item {i * 5}" for i in range(9)]
    prefixes = {}
    for pkg, kw in ((leann_torch, {"device": "cpu"}), (leann_tpu, {})):
        b = pkg.LeannBuilder(backend_name="flat", embedding_model="nomic-embed-text", embedding_mode="ollama", **kw)
        for t in texts:
            b.add_text(t)
        prefixes[pkg.__name__] = str(tmp_path / f"{pkg.__name__}.leann")
        b.build_index(prefixes[pkg.__name__])
    stored = {n: np.load(p + ".flat.npz")["embeddings"] for n, p in prefixes.items()}
    assert np.array_equal(stored["leann_torch"], stored["leann_tpu"])
    e = t_compute._ollama_embeddings(texts, "nomic-embed-text", host=fake.host)
    assert np.array_equal(stored["leann_torch"], e)

    s = leann_torch.LeannSearcher(prefixes["leann_torch"], device="cpu")
    assert s.distance_metric == "mips"
    got = s.search(queries, top_k=5)
    q = t_compute._ollama_embeddings(queries, "nomic-embed-text", host=fake.host)
    ids, dists = flat_search(pad_features(torch.from_numpy(e).to(torch.bfloat16)), pad_features(torch.from_numpy(q)),
                             len(texts), 5, "mips", en=torch.from_numpy(e).square().sum(dim=1))
    assert [[r.id for r in row] for row in got] == [[str(i) for i in row] for row in ids.tolist()]
    assert np.array_equal(np.array([[r.score for r in row] for row in got], np.float32), dists.numpy())
    single = s.search(queries[0], top_k=5)
    assert [r.id for r in single] == [r.id for r in got[0]]
    j_got = leann_tpu.LeannSearcher(prefixes["leann_tpu"]).search(queries, top_k=5)
    assert np.mean([{r.id for r in a} == {r.id for r in b} for a, b in zip(got, j_got)]) >= 0.9

    _to_host(monkeypatch, UNREACHABLE)
    for query in (queries[0], queries):
        with pytest.raises(RuntimeError, match="Could not connect to Ollama"):
            s.search(query, top_k=5)


# ---------------------------------------------------------------------------
# the chat layer
# ---------------------------------------------------------------------------


def test_chat_validators_match_jax(fake, tmp_path):
    calls = [
        lambda m: m.validate_ollama_chat_model("nomic-embed-text", host=fake.host),
        lambda m: m.validate_ollama_chat_model("all-minilm:l6-v2", host=fake.host),
        lambda m: m.validate_ollama_chat_model("nomic-embed-txt", host=fake.host),
        lambda m: m.validate_ollama_chat_model("m", host=UNREACHABLE),
        lambda m: m.list_local_ollama_models(host=fake.host),
        lambda m: m.list_local_ollama_models(host=UNREACHABLE, timeout=1),
        lambda m: m.validate_hf_model(str(tmp_path)),
        lambda m: m.validate_hf_model("Qwen/Qwen3-0.6"),
        lambda m: m.validate_hf_model("nobody/nothing"),
    ]
    avail = ["llama3.2:1b", "llama3.2:3b", "qwen2.5:7b", "nomic-embed-text:latest"]
    for q in ("llama3.2", "qwen", "lama3.2:1b", "nomic", "zzz", "QWEN2.5:7B"):
        calls.append(lambda m, q=q: m.suggest_similar_models(q, avail))
    outs = [(_outcome(lambda: c(j_chat)), _outcome(lambda: c(t_chat))) for c in calls]
    for want, got in outs:
        assert got == want
    assert outs[0][1] == ("ok", "nomic-embed-text:latest")
    hint = outs[2][1]
    assert hint[0] == "raised" and "ollama pull" in hint[1][1] and "nomic-embed-text:latest" in hint[1][1]
    assert outs[3][1] == ("ok", "m") and outs[5][1] == ("ok", [])
    assert outs[7][1][0] == "raised" and "Qwen/Qwen3-0.6B" in outs[7][1][1][1]


def test_get_llm_matches_jax(fake):
    for config in ({}, {"type": "simulated"}, {"type": "SIMULATED"}):
        assert type(t_chat.get_llm(config)).__name__ == type(j_chat.get_llm(config)).__name__ == "SimulatedChat"
    o = t_chat.get_llm({"type": "ollama", "model": "nomic-embed-text", "host": fake.host, "thinking_budget": "low"})
    jo = j_chat.get_llm({"type": "ollama", "model": "nomic-embed-text", "host": fake.host, "thinking_budget": "low"})
    assert isinstance(o, t_chat.OllamaChat) and (o.model, o.host, o.thinking_budget) == (jo.model, jo.host,
                                                                                        jo.thinking_budget)
    for config in ({"type": "nope"}, {"type": "ollama", "model": "nomic-embed-txt", "host": fake.host},
                   {"type": "hf", "model": "nobody/nothing"}):
        assert _outcome(lambda: t_chat.get_llm(config)) == _outcome(lambda: j_chat.get_llm(config))
        assert _outcome(lambda: t_chat.get_llm(config))[0] == "raised"
    prompt = "Context:\nsome retrieved text\n\nQuestion: q\n\nAnswer:"
    assert t_chat.SimulatedChat().ask(prompt) == j_chat.SimulatedChat().ask(prompt)


def test_hf_chat_runs_only_where_asked(tmp_path):
    """The hf model goes to the port's device: without CUDA the default
    raises before any checkpoint is read, and never runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        t_chat.get_llm({"type": "hf", "model": str(tmp_path)})
    with pytest.raises(RuntimeError, match="device='cuda'"):
        t_chat.HFChat(str(tmp_path))


def test_leann_chat_ask_matches_jax(tmp_path):
    """The same index (simulated embeddings, so both packages embed alike)
    and question: LeannChat gives the LLM the same prompt, and the simulated
    LLM the same answer, in both packages."""
    texts = [f"note {i}: the {['red', 'green', 'blue'][i % 3]} planet number {i} has {i % 4} moons" for i in range(40)]
    b = leann_torch.LeannBuilder(backend_name="flat", embedding_model="sim", embedding_mode="simulated", device="cpu")
    for t in texts:
        b.add_text(t, metadata={"i": texts.index(t)})
    prefix = str(tmp_path / "chat.leann")
    b.build_index(prefix)
    chats = {"torch": leann_torch.LeannChat(prefix, device="cpu", system_prompt="be brief"),
             "jax": leann_tpu.LeannChat(prefix, system_prompt="be brief")}
    prompts = {}
    for name, c in chats.items():
        real = c.llm.ask

        def recording(prompt, system=None, _real=real, _name=name, **kw):
            prompts[_name] = (prompt, system)
            return _real(prompt, system=system, **kw)

        c.llm.ask = recording
    for question in ("which planet is green?", "moons of planet 7"):
        answers = {name: c.ask(question, top_k=4) for name, c in chats.items()}
        assert answers["torch"] == answers["jax"] and answers["torch"].startswith("[simulated] Based on")
        assert prompts["torch"] == prompts["jax"] and prompts["torch"][1] == "be brief"
        assert f"Question: {question}" in prompts["torch"][0]
    for c in chats.values():
        c.cleanup()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            leann_torch.LeannChat(prefix)
