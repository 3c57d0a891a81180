"""leann_torch's RAG apps and examples (leann_torch/apps, leann_torch/examples)
against the JAX package's apps/ and examples/ on the CPU, on fixtures
written here from numpy seeds (chip_smoke.py's generators at small sizes):
the readers (Apple Mail .emlx, Chrome history, WeChat exports and the
exporter), each app's load_data, DocumentRAG.run() across packages (the
same passages, indexes each package searches alike, the simulated answer
over the searcher's texts), the book examples, the apps' default device,
and the repairs the slice carries (the event loop of build_index, the
trainer's mesh parameter)."""

import asyncio
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the smoke's fixture generators; it imports torch lazily)
import leann_torch  # noqa: E402
import leann_tpu  # noqa: E402
from apps import browser_rag as j_browser  # noqa: E402
from apps import code_rag as j_code  # noqa: E402
from apps import document_rag as j_document  # noqa: E402
from apps import email_rag as j_email  # noqa: E402
from apps import wechat_exporter as j_exporter  # noqa: E402
from apps import wechat_rag as j_wechat  # noqa: E402
from apps.email_data import email_reader as j_mail  # noqa: E402
from apps.history_data import history as j_history  # noqa: E402
from apps.history_data import wechat_history as j_wx  # noqa: E402
from leann_torch.apps import browser_rag as t_browser  # noqa: E402
from leann_torch.apps import code_rag as t_code  # noqa: E402
from leann_torch.apps import document_rag as t_document  # noqa: E402
from leann_torch.apps import email_rag as t_email  # noqa: E402
from leann_torch.apps import wechat_exporter as t_exporter  # noqa: E402
from leann_torch.apps import wechat_rag as t_wechat  # noqa: E402
from leann_torch.apps.email_data import email_reader as t_mail  # noqa: E402
from leann_torch.apps.history_data import history as t_history  # noqa: E402
from leann_torch.apps.history_data import wechat_history as t_wx  # noqa: E402
from leann_torch.examples import basic_demo, spoiler_free_book_rag  # noqa: E402

TINY = ["--embedding-model", "hash-tiny", "--max-length", "64"]
SEARCH_KW = dict(top_k=5, complexity=64, beam_width=8, prune_ratio=0.0)  # the apps' search defaults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The indexes here are tiny: one intra-op thread, so that a worker
    beside others does not wait on thread hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def test_parse_emlx_matches_jax(tmp_path):
    """Plain, multipart (plain + HTML), HTML-only and truncated .emlx files:
    the port's parse gives the JAX package's dict (None where it does)."""
    from datetime import datetime, timezone

    when = datetime(2024, 3, 1, 12, 0, tzinfo=timezone.utc)
    paras = ["Quarterly numbers look fine. The memo is attached.", "Second paragraph here."]
    html_only = (b"From: a@example.com\r\nTo: b@example.com\r\nSubject: Markup\r\nMIME-Version: 1.0\r\n"
                 b'Content-Type: text/html; charset="us-ascii"\r\n\r\n<html><body><p>Hello <b>there</b></p>'
                 b"</body></html>\r\n")
    plain = chip_smoke.rfc822_message(1, 0, paras, when, html=False)
    cases = {
        "plain": b"%d\n" % len(plain) + plain + b"<plist/>",
        "multipart": chip_smoke.rfc822_message(2, 0, paras, when, html=True),
        "html_only": html_only,
        "cut_body": b"%d\n" % (len(plain) - 20) + plain,
        "longer_count": b"%d\n" % (len(plain) + 500) + plain,
        "no_count": plain,
        "count_only": b"123",
    }
    cases["multipart"] = b"%d\n" % len(cases["multipart"]) + cases["multipart"] + b"<plist/>"
    cases["html_only"] = b"%d\n" % len(html_only) + html_only
    parsed = {}
    for name, raw in cases.items():
        f = tmp_path / f"{name}.emlx"
        f.write_bytes(raw)
        parsed[name] = t_mail.parse_emlx(str(f))
        assert parsed[name] == j_mail.parse_emlx(str(f)), name
    assert parsed["plain"]["body"].startswith("Quarterly") and parsed["multipart"]["body"] == parsed["plain"]["body"]
    assert "<b>" not in parsed["html_only"]["body"] and "Hello" in parsed["html_only"]["body"]
    assert parsed["no_count"] is None and parsed["count_only"] is None


def test_mail_discovery_and_loading_match_jax(tmp_path, monkeypatch):
    home = tmp_path / "home"
    mail = chip_smoke.write_mail_folder(str(home), 30, seed=3)
    monkeypatch.setenv("HOME", str(home))
    dirs = t_mail.find_mail_directories()
    assert dirs == j_mail.find_mail_directories() and sorted(dirs) == sorted(mail["dirs"])
    assert t_mail.find_mail_directories(str(tmp_path / "nowhere")) == []
    for max_count in (-1, 7):
        got = t_mail.load_emails(max_count=max_count)
        assert got == j_mail.load_emails(max_count=max_count)
        assert len(got) == (30 if max_count < 0 else 7)


def test_history_readers_match_jax(tmp_path, monkeypatch):
    """Two Chrome profiles found through HOME, loaded whole and up to
    max_count; rows with neither a title nor a URL are skipped alike."""
    import sqlite3

    home = tmp_path / "home"
    hist = chip_smoke.write_chrome_history(str(home), 300, seed=4)
    conn = sqlite3.connect(hist["dbs"][1])
    conn.execute("INSERT INTO urls(url, title, visit_count, last_visit_time) VALUES ('', '', 3, 1)")
    conn.commit()
    conn.close()
    monkeypatch.setenv("HOME", str(home))
    dbs = t_history.find_history_databases()
    assert dbs == j_history.find_history_databases() == hist["dbs"]
    for max_count in (-1, 50, 250):
        got = t_history.load_history(max_count=max_count)
        assert got == j_history.load_history(max_count=max_count)
        assert len(got) == (300 if max_count < 0 else max_count)
    assert {e["profile"] for e in t_history.load_history()} == {"Default", "Profile 1"}


T0 = 1_700_000_000
TWEAK = [
    {"fromUser": "wxid_bob", "content": "wxid_bob:\nlunch tomorrow?", "createTime": T0, "isSentFromSelf": False},
    {"fromUser": "me", "content": "sure, noon works", "createTime": T0 + 60, "isSentFromSelf": True},
    {"fromUser": "wxid_bob", "createTime": T0 + 120, "content": '<msg><img cdnurl="http://x" aeskey="k"/></msg>',
     "message": "[Image]"},
    {"fromUser": "wxid_bob", "createTime": T0 + 130, "content": '<msg><emoji productid="p" md5="m"/></msg>'},
    {"fromUser": "wxid_bob", "createTime": T0 + 140, "content": '"wxid_bob" recalled a message'},
    {"fromUser": "wxid_bob", "createTime": T0 + 200, "content": {"title": "re: lunch", "quoted": "sure, noon works"}},
    {"fromUser": "wxid_bob", "content": "wxid_bob:\nrunning late", "createTime": T0 + 4000, "isSentFromSelf": False},
] + [{"fromUser": "wxid_bob", "content": f"wxid_bob:\nmsg {i} " + "x" * 40, "createTime": T0 + 5000 + i}
     for i in range(6)]
SIMPLE = [{"contact": "alice", "messages": [
    {"from": "alice", "time": "2024-01-01", "text": "hello <img>x</img>"},
    {"from": "me", "time": "2024-01-01", "text": "hi [smile]"},
    {"from": "alice", "time": "2024-01-02", "text": "<emoji/>"},
] + [{"from": "alice", "time": "2024-01-03", "text": f"line {i} " + "y" * 30} for i in range(30)]}]


@pytest.mark.parametrize("kw", [
    {}, {"concatenate": False}, {"include_non_text": True}, {"include_non_text": True, "concatenate": False},
    {"max_length": 100, "overlap_messages": 1}, {"time_window_minutes": -1, "max_length": -1},
    {"window": 4, "max_count": 5}, {"window": 0},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_wechat_export_reader_matches_jax(tmp_path, kw):
    """Both export shapes (WeChatTweak's flat list with media, recalls,
    quoted dicts and time gaps; the exporter's simplified shape), in both
    modes, with include_non_text, max_length / overlap and the window."""
    (tmp_path / "bob.json").write_text(json.dumps(TWEAK))
    (tmp_path / "alice.json").write_text(json.dumps(SIMPLE))
    (tmp_path / "broken.json").write_text("{not json")
    got = t_wx.load_wechat_export(str(tmp_path), **kw)
    assert got == j_wx.load_wechat_export(str(tmp_path), **kw)
    assert got and {c["metadata"]["contact"] for c in got} <= {"alice", "bob"}


def test_wechat_exporter_matches_jax(tmp_path):
    db = tmp_path / "msg_0.db"
    chip_smoke.write_wechat_db(str(db), 3, 60, seed=5)
    for limit in (0, 25):
        outs = []
        for name, mod in (("t", t_exporter), ("j", j_exporter)):
            out = tmp_path / f"{name}{limit}"
            out.mkdir()
            assert mod.export_db(str(db), str(out), limit_per_chat=limit) == 3
            outs.append({p.name: p.read_bytes() for p in sorted(out.iterdir())})
        assert outs[0] == outs[1] and len(outs[0]) == 3
    assert t_exporter.find_message_dbs(str(tmp_path)) == j_exporter.find_message_dbs(str(tmp_path)) == [str(db)]


# ---------------------------------------------------------------------------
# the apps' load_data
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("apps")
    home = root / "home"
    chip_smoke.write_mail_folder(str(home), 40, seed=7)
    chip_smoke.write_chrome_history(str(home), 400, seed=8)
    db = root / "msg_0.db"
    chip_smoke.write_wechat_db(str(db), 4, 80, seed=9)
    (root / "export").mkdir()
    t_exporter.export_db(str(db), str(root / "export"))
    chip_smoke.make_document_folder(str(root / "docs"), seed=10, n_prose=6, n_py=4, n_brace=2)
    code = root / "code"
    for sub in ("pkg", "build", "node_modules"):
        (code / sub).mkdir(parents=True)
    for i in range(3):
        (code / "pkg" / f"m{i}.py").write_text(f'"""Module {i}."""\n\n\ndef f{i}(x):\n    return x + {i}\n\n\n'
                                              f"class C{i}:\n    def g(self):\n        return {i}\n")
    (code / "README.md").write_text("# Code\n\nA small package of three modules.\n")
    (code / "pkg" / "web.ts").write_text("export function add(a: number, b: number) {\n  return a + b;\n}\n")
    (code / "build" / "gen.py").write_text("SKIPPED = True\n")
    (code / "node_modules" / "dep.ts").write_text("export const skipped = 1;\n")
    return root


APPS = {
    "email": (t_email.EmailRAG, j_email.EmailRAG, lambda r: []),
    "email_capped": (t_email.EmailRAG, j_email.EmailRAG, lambda r: ["--max-items", "9", "--chunk-size", "64"]),
    "browser": (t_browser.BrowserRAG, j_browser.BrowserRAG, lambda r: ["--history-db", *sorted(
        str(p) for p in (r / "home").rglob("History"))]),
    "browser_found": (t_browser.BrowserRAG, j_browser.BrowserRAG, lambda r: ["--max-items", "120"]),
    "wechat": (t_wechat.WeChatRAG, j_wechat.WeChatRAG, lambda r: ["--export-dir", str(r / "export")]),
    "code": (t_code.CodeRAG, j_code.CodeRAG, lambda r: ["--repo-dir", str(r / "code")]),
    "document": (t_document.DocumentRAG, j_document.DocumentRAG, lambda r: ["--data-dir", str(r / "docs")]),
    "document_capped": (t_document.DocumentRAG, j_document.DocumentRAG,
                        lambda r: ["--data-dir", str(r / "docs"), "--max-items", "4", "--use-ast-chunking"]),
}


@pytest.mark.parametrize("app", list(APPS))
def test_load_data_matches_jax(fixtures, monkeypatch, app):
    """Each app's load_data on the same argv gives the JAX app's chunks:
    texts and metadata, in order (discovery through HOME where the app
    finds its data itself)."""
    t_cls, j_cls, argv = APPS[app]
    monkeypatch.setenv("HOME", str(fixtures / "home"))
    argv = argv(fixtures)
    t_app, j_app = t_cls(), j_cls()
    got = asyncio.run(t_app.load_data(t_app.parser.parse_args(argv)))
    want = asyncio.run(j_app.load_data(j_app.parser.parse_args(argv)))
    assert got == want and len(got) > 0
    if app == "code":
        assert not any("SKIPPED" in c["text"] or "skipped" in c["text"] for c in got)


# ---------------------------------------------------------------------------
# DocumentRAG across packages
# ---------------------------------------------------------------------------


def _texts(prefix):
    with open(prefix + ".passages.jsonl") as f:
        return [json.loads(line)["text"] for line in f]


def _ids(rows):
    return [[r.id for r in row] for row in rows]


def test_document_rag_runs_across_packages(fixtures, tmp_path, monkeypatch, capsys):
    """DocumentRAG.run() in both packages over one folder (hnsw, hash-tiny):
    the same passages file; each package's searcher on the other's index
    gives the native searcher's top-5 for >= 90% of 32 queries; the
    simulated answer is the searcher's top texts; a second run() reuses the
    index. The first three files of the folder (a PDF and two notes, 65
    chunks)."""
    docs = str(fixtures / "docs")
    monkeypatch.setenv("LEANN_HOME", str(tmp_path / "leann_home"))
    monkeypatch.chdir(tmp_path)
    q = "w1 w2 w3 notes planning"
    common = ["--data-dir", docs, "--max-items", "3", *TINY, "--query", q]
    t_dir, j_dir = str(tmp_path / "pt"), str(tmp_path / "jx")
    t_document.DocumentRAG().run([*common, "--index-dir", t_dir, "--device", "cpu"])
    t_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["document_rag.py", *common, "--index-dir", j_dir])
    # the JAX app takes the thread's current loop (asyncio.get_event_loop),
    # which an asyncio.run() earlier in this thread has unset: give it one
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    try:
        j_document.DocumentRAG().run()
    finally:
        asyncio.set_event_loop(None)
        loop.close()
    j_out = capsys.readouterr().out
    t_prefix, j_prefix = (os.path.join(d, "documents.leann") for d in (t_dir, j_dir))
    assert Path(t_prefix + ".passages.jsonl").read_bytes() == Path(j_prefix + ".passages.jsonl").read_bytes()

    searcher = leann_torch.LeannSearcher(t_prefix, device="cpu")
    j_searcher = leann_tpu.LeannSearcher(j_prefix)
    for out, s in ((t_out, searcher), (j_out, j_searcher)):
        context = "\n\n".join(r.text for r in s.search(q, **SEARCH_KW))
        assert f"[simulated] Based on the retrieved context: {context[:200].replace(chr(10), ' ')}" in out
        assert "Indexing" in out

    texts = sorted(_texts(t_prefix))
    rng = np.random.default_rng(21)
    queries = [" ".join(texts[i].split()[:12]) for i in rng.choice(len(texts), 32, replace=False)]
    searchers = {("t", "t"): searcher, ("t", "j"): leann_tpu.LeannSearcher(t_prefix), ("j", "j"): j_searcher,
                 ("j", "t"): leann_torch.LeannSearcher(j_prefix, device="cpu")}
    res = {key: _ids(s.search(queries, **SEARCH_KW)) for key, s in searchers.items()}
    for built in ("t", "j"):
        other = "j" if built == "t" else "t"
        native, cross = res[(built, built)], res[(built, other)]
        assert np.mean([set(a) == set(b) for a, b in zip(native, cross)]) >= 0.9, built

    t_document.DocumentRAG().run([*common, "--index-dir", t_dir, "--device", "cpu"])
    again = capsys.readouterr().out
    assert "skipping build" in again and "Indexing" not in again


def test_build_index_from_a_worker_thread(fixtures, tmp_path, monkeypatch):
    """The port's build_index runs load_data on a loop of its own, so an app
    builds from a thread that has no event loop."""
    monkeypatch.setenv("LEANN_HOME", str(tmp_path / "leann_home"))
    app = t_document.DocumentRAG()
    args = app.parser.parse_args(["--data-dir", str(fixtures / "docs"), "--max-items", "2", *TINY,
                                  "--index-dir", str(tmp_path / "idx"), "--device", "cpu"])
    out = {}

    def work():
        try:
            out["prefix"] = app.build_index(args)
        except BaseException as e:  # noqa: BLE001 - handed to the test's thread
            out["error"] = e

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and "error" not in out, out.get("error")
    assert os.path.exists(out["prefix"] + ".meta.json")


# ---------------------------------------------------------------------------
# the book examples and the default device
# ---------------------------------------------------------------------------


def test_book_examples(tmp_path, monkeypatch, capsys):
    """On a generated 6-chapter book of 18 paragraphs: basic_demo prints
    three results and an answer; the spoiler-free demo at --up-to-chapter
    3, asked a chapter-2 paragraph, returns results and none above chapter
    3."""
    monkeypatch.setenv("LEANN_HOME", str(tmp_path / "leann_home"))
    book = chip_smoke.write_book(str(tmp_path / "book.txt"), 6, 3, seed=12)
    basic_demo.main(["--book", str(tmp_path / "book.txt"), "--index-dir", str(tmp_path / "demo"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Built index with 18 chunks" in out
    assert sum(line.startswith("[") for line in out.splitlines()) == 3
    assert "A: [simulated] Based on the retrieved context:" in out
    ch2 = next(p for ch, p in book["paragraphs"] if ch == 2)
    spoiler_free_book_rag.main(["--book", str(tmp_path / "book.txt"), "--index-dir", str(tmp_path / "sf"),
                                "--up-to-chapter", "3", "--query", ch2, "--device", "cpu"])
    out = capsys.readouterr().out
    chapters = [int(line.split("[ch.")[1].split("]")[0]) for line in out.splitlines() if line.startswith("  [ch.")]
    assert "Indexed 6 chapters" in out and chapters and max(chapters) <= 3
    assert "A: [simulated]" in out


@pytest.mark.parametrize("example", [basic_demo, spoiler_free_book_rag])
def test_examples_without_a_book_exit_with_a_message(tmp_path, example):
    with pytest.raises(SystemExit, match="no book at .*pass --book"):
        example.main(["--index-dir", str(tmp_path / "idx"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no book at .*missing.txt"):
        example.main(["--book", str(tmp_path / "missing.txt"), "--index-dir", str(tmp_path / "idx"), "--device", "cpu"])


@pytest.mark.parametrize("entry", ["email", "browser", "wechat", "code", "document", "basic_demo", "spoiler"])
def test_default_device_without_cuda_exits(entry, tmp_path, monkeypatch):
    """Without CUDA each app's and example's default device (cuda) exits with
    resolve_device's message before it reads any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"email": t_email.EmailRAG().run, "browser": t_browser.BrowserRAG().run,
           "wechat": t_wechat.WeChatRAG().run, "code": t_code.CodeRAG().run,
           "document": t_document.DocumentRAG().run, "basic_demo": basic_demo.main,
           "spoiler": spoiler_free_book_rag.main}[entry]
    argv = ["--export-dir", str(tmp_path)] if entry == "wechat" else []
    with pytest.raises(SystemExit, match="CUDA is not available"):
        run(argv + ["--index-dir", str(tmp_path / "idx")])
    assert not (tmp_path / "idx").exists()


# ---------------------------------------------------------------------------
# the trainer's second parameter
# ---------------------------------------------------------------------------


def test_trainer_takes_the_jax_positional_mesh():
    """The JAX package's form ContrastiveTrainer(cfg, mesh, learning_rate)
    trains over the mesh, with the learning rate where it was given,
    positional or not; the keyword form still trains on one device."""
    import torch

    from leann_torch.embeddings.encoder import MODEL_REGISTRY
    from leann_torch.parallel.mesh import make_mesh
    from leann_torch.parallel.train import ContrastiveTrainer

    cfg = MODEL_REGISTRY["hash-tiny"]
    mesh = make_mesh([("dp", 2), ("tp", 2)], [torch.device("cpu")] * 4)
    for args, kw, lr in (((mesh,), {"learning_rate": 1e-3}, 1e-3), ((mesh, 5e-4), {}, 5e-4), ((mesh,), {}, 2e-5)):
        tr = ContrastiveTrainer(cfg, *args, **kw)
        assert tr.mesh is mesh and tr.optimizer.param_groups[0]["lr"] == lr
    assert (tr.dp, tr.tp) == (2, 2)
    tr = ContrastiveTrainer(cfg, learning_rate=1e-3, device="cpu")
    assert tr.mesh is None and tr.optimizer.param_groups[0]["lr"] == 1e-3
    tr = ContrastiveTrainer(cfg, None, 5e-4, device="cpu")
    assert tr.optimizer.param_groups[0]["lr"] == 5e-4
