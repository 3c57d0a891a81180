"""The port's user surface on the CPU, held against the JAX package on the
same inputs: chunking, document loading and the built-in PDF reader
(identical output), the MCP server's requests and its shell-out to the
port's CLI, the CLI's commands in-process, an index that one package's CLI
built found by name and searched by the other's, the two project
registries, and the CLI's explicit device."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "benchmarks"))

import chip_smoke  # noqa: E402  (the smoke's folder generator and PDF writer; it imports torch lazily)
import leann_torch  # noqa: E402
import leann_tpu  # noqa: E402
from leann_torch import chunking as t_chunking  # noqa: E402
from leann_torch import cli as t_cli  # noqa: E402
from leann_torch import loaders as t_loaders  # noqa: E402
from leann_torch import mcp as t_mcp  # noqa: E402
from leann_tpu import chunking as j_chunking  # noqa: E402
from leann_tpu import cli as j_cli  # noqa: E402
from leann_tpu import loaders as j_loaders  # noqa: E402
from leann_tpu import mcp as j_mcp  # noqa: E402

# ---------------------------------------------------------------------------
# chunking: every input of tests/test_surface.py's TestChunking and
# TestStructuralCodeChunking through both packages
# ---------------------------------------------------------------------------

_BIG_PY = textwrap.dedent('''
    import os

    def alpha():
        """First function."""
        return 1

    class Big:
        def method_one(self):
            return "one"

        def method_two(self):
            return "two"

    def omega():
        return 3
''')
_JAVA_METHODS = "\n".join(
    f"    public int method{i}() {{\n        int x{i} = {i} * compute_some_value_{i}(alpha, beta, gamma);\n"
    f"        return x{i} + offset_{i};\n    }}" for i in range(12))
_CODE = {
    "python_ast": (_BIG_PY, "m.py"),
    "syntax_error": ("def broken(:\n  pass", "b.py"),
    "go_heuristic": ("func main() {\n\tfmt.Println(1)\n}\n\nfunc helper() {\n\treturn\n}\n", "m.go"),
    "java_class": (f"public class Big {{\n{_JAVA_METHODS}\n}}\n", "Big.java"),
    "js_template": ('function a() {\n  const s = `hello ${ {deep: "}"} } world`;\n}\nfunction b() { return 2; }\n',
                    "t.js"),
    "c_strings_comments": ('int f() {\n  // ignore } this\n  char* s = "also } {";\n  /* and } */\n  return 1;\n}\n'
                           'int g() { return 2; }\n', "f.c"),
    "go_units": ('package main\n\nimport "fmt"\n\nfunc main() {\n\tfmt.Println(`raw } string`)\n}\n\n'
                 'func helper() int {\n\treturn 1\n}\n', "main.go"),
    "rust_lifetimes": ("fn get<'a>(x: &'a str) -> &'a str {\n    let c = 'x';\n    x\n}\nfn two() -> i32 { 2 }\n",
                       "l.rs"),
    "unbalanced": ("function broken() { if (x) { return 1;\n", "b.js"),
    "small_units": ("\n".join(f"const v{i} = {i};" for i in range(20)) + "\n", "a.ts"),
    "ruby_heuristic": ("def a\n  1\nend\n\nclass B\n  def c\n    2\n  end\nend\n" * 6, "r.rb"),
}
_LEXER_LANG = {"js_template": "javascript", "c_strings_comments": "c", "go_units": "go", "rust_lifetimes": "rust"}


def _docs(name):
    text, path = _CODE[name]
    return [{"text": text, "metadata": {"file_path": path}}]


_TRAD_SIZES = ". ".join(f"sentence number {i} with several words here" for i in range(100))
_TRAD_OVERLAP = ". ".join(f"s{i} alpha beta gamma delta" for i in range(40))
CHUNK_CASES = {
    "traditional_sizes": ("create_text_chunks", ([{"text": _TRAD_SIZES}],), dict(chunk_size=50, chunk_overlap=10)),
    "traditional_overlap": ("create_text_chunks", ([{"text": _TRAD_OVERLAP}],), dict(chunk_size=30, chunk_overlap=15)),
    "metadata": ("create_text_chunks", ([{"text": "hello world. " * 100, "metadata": {"src": "x"}}],),
                 dict(chunk_size=40, chunk_overlap=0)),
    "traditional_direct": ("create_traditional_chunks", ([_TRAD_SIZES, _TRAD_OVERLAP], 50, 10, [{"a": 1}, {"b": 2}]),
                           {}),
    "cjk_and_long_sentence": ("create_text_chunks",
                              ([{"text": "这是一个很长的中文句子" * 80 + "。 " + "word " * 700}],),
                              dict(chunk_size=64, chunk_overlap=16)),
    "unified_router": ("create_text_chunks", ([
        {"text": "prose sentence one. prose sentence two.", "metadata": {"file_path": "a.txt"}},
        {"text": "def f():\n    return 1\n", "metadata": {"file_path": "a.py"}}],), dict(use_ast_chunking=True)),
    "router_code_exts": ("create_text_chunks",
                         ([{"text": _BIG_PY, "metadata": {"file_path": "m.py"}},
                           {"text": _CODE["java_class"][0], "metadata": {"file_path": "B.java"}}],),
                         dict(use_ast_chunking=True, ast_chunk_size=12, code_file_extensions=[".py"])),
    "no_fallback_raises": ("create_text_chunks", (_docs("syntax_error"),),
                           dict(use_ast_chunking=True, ast_fallback_traditional=False)),
    "ast_no_fallback_raises": ("create_ast_chunks", (_docs("syntax_error"),), dict(fallback_traditional=False)),
}
for _name in _CODE:
    for _size in (4, 10, 30, 40, 512):
        CHUNK_CASES[f"ast_{_name}_{_size}"] = ("create_ast_chunks", (_docs(_name),), dict(max_chunk_size=_size))
for _name, _lang in _LEXER_LANG.items():
    CHUNK_CASES[f"units_{_name}"] = ("_top_level_units", (_CODE[_name][0], _lang), {})


def _run(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the two packages must fail alike
        return "raised", (type(e).__name__, str(e))


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunking_identical_to_jax(case):
    fn, args, kwargs = CHUNK_CASES[case]
    want = _run(lambda: getattr(j_chunking, fn)(*args, **kwargs))
    got = _run(lambda: getattr(t_chunking, fn)(*args, **kwargs))
    assert got == want
    if case.endswith("raises"):
        assert got[0] == "raised" and got[1][0] == "SyntaxError"
    else:
        assert got[0] == "ok" and got[1]


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


@pytest.fixture()
def doc_tree(tmp_path):
    t = tmp_path / "tree"
    files = {
        "keep.txt": "keep me please. second sentence.",
        "skip.log": "skip me",
        "keep.log": "negated: kept",
        "anchored.txt": "ignored at the root only",
        "sub/anchored.txt": "kept below the root",
        "secret/hidden.txt": "secret stuff",
        ".hidden.txt": "hidden file",
        ".hiddendir/x.md": "# hidden dir",
        "sub/a.md": "# title\nbody text",
        "sub/b.py": "def f():\n    return 1\n",
        "sub/deep/c.ts": "export function g(): number { return 2; }\n",
        "page.html": "<html><body><p>html words</p><script>x</script></body></html>",
        "data.json": '{"k": "json text"}',
        "blank.txt": "   \n  ",
        "node_modules/x.js": "excluded dir",
        "submod/inner.txt": "a submodule's file",
        "notes.unknownext": "not a default type",
    }
    for rel, text in files.items():
        p = t / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    (t / ".gitignore").write_text("# comment\n*.log\n!keep.log\nsecret/\n/anchored.txt\n")
    (t / ".gitmodules").write_text('[submodule "submod"]\n\tpath = submod\n\turl = x\n')
    chip_smoke.write_flate_pdf(t / "memo.pdf", ["pdf text (with parens) and a \\ backslash", "second line"])
    return t


LOAD_CASES = {
    "default": {},
    "hidden": {"include_hidden": True},
    "no_gitignore": {"use_gitignore": False},
    "max_items": {"max_items": 3},
    "file_types": {"file_types": [".py", "ts"]},
    "max_size": {"max_file_size_mb": 2e-5},
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_documents_identical_to_jax(doc_tree, case):
    kwargs = LOAD_CASES[case]
    want = j_loaders.load_documents(str(doc_tree), **kwargs)
    got = t_loaders.load_documents(str(doc_tree), **kwargs)
    assert got == want and got
    names = [d["metadata"]["file_name"] for d in got]
    if case == "default":
        assert "keep.log" in names and "skip.log" not in names and "hidden.txt" not in names
        assert ".hidden.txt" not in names and "inner.txt" not in names and "x.js" not in names
        assert sum(n == "anchored.txt" for n in names) == 1 and "memo.pdf" in names
    if case == "max_items":
        assert len(got) == 3


def test_single_file_identical_to_jax(doc_tree):
    for rel in ("sub/a.md", "memo.pdf"):
        assert t_loaders.load_documents(str(doc_tree / rel)) == j_loaders.load_documents(str(doc_tree / rel))


def test_written_pdf_identical_to_jax(tmp_path):
    """A PDF written here with a Flate text stream: both packages'
    extract_pdf_text (and the built-in reader under it) give the same text,
    which holds every line."""
    lines = ["Quarterly planning memo", "escapes (a) b \\ c", "third line of the memo"]
    path = tmp_path / "memo.pdf"
    chip_smoke.write_flate_pdf(path, lines)
    got, want = t_loaders.extract_pdf_text(str(path)), j_loaders.extract_pdf_text(str(path))
    assert got == want
    assert t_loaders._builtin_pdf_text(str(path)) == j_loaders._builtin_pdf_text(str(path))
    for ln in lines:
        assert ln in got


def test_generated_folder_chunks_identical_to_jax(tmp_path):
    """chip_smoke's document folder at a small size: the same documents and
    chunks in both packages, no ignored or hidden file, the PDF's text."""
    chip_smoke.make_document_folder(str(tmp_path), seed=3, n_prose=6, n_py=3, n_brace=2)
    docs = t_loaders.load_documents(str(tmp_path))
    assert docs == j_loaders.load_documents(str(tmp_path))
    chunks = t_chunking.create_text_chunks(docs, use_ast_chunking=True)
    assert chunks == j_chunking.create_text_chunks(docs, use_ast_chunking=True)
    texts = [c["text"] for c in chunks]
    assert not any(m in t for t in texts for m in chip_smoke.SURFACE_MARKERS.values())
    assert any(chip_smoke.PDF_PHRASE in t for t in texts)
    assert {c["metadata"]["extension"] for c in chunks} == {".md", ".txt", ".pdf", ".py", ".ts", ".go", ".java"}


# ---------------------------------------------------------------------------
# MCP
# ---------------------------------------------------------------------------


def test_mcp_requests_match_jax():
    init = t_mcp.handle_request({"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}})
    j_init = j_mcp.handle_request({"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}})
    assert init["result"]["serverInfo"]["name"] == "leann-torch-mcp"
    j_init["result"]["serverInfo"]["name"] = "leann-torch-mcp"
    assert init == j_init
    tools = t_mcp.handle_request({"jsonrpc": "2.0", "id": 2, "method": "tools/list"})["result"]["tools"]
    j_tools = j_mcp.handle_request({"jsonrpc": "2.0", "id": 2, "method": "tools/list"})["result"]["tools"]
    assert [t["name"] for t in tools] == [t["name"] for t in j_tools] == ["leann_search", "leann_list"]
    assert [t["inputSchema"] for t in tools] == [t["inputSchema"] for t in j_tools]
    for req in ({"jsonrpc": "2.0", "id": 3, "method": "nope"},
                {"jsonrpc": "2.0", "id": 4, "method": "tools/call", "params": {"name": "nope", "arguments": {}}}):
        resp = t_mcp.handle_request(req)
        assert resp == j_mcp.handle_request(req) and resp["error"]["code"] == -32601
    for note in ({"jsonrpc": "2.0", "method": "notifications/initialized"}, {"jsonrpc": "2.0", "method": "nope"}):
        assert t_mcp.handle_request(note) is None and j_mcp.handle_request(note) is None


def test_mcp_tool_calls_spawn_the_port_cli_with_the_device(monkeypatch):
    seen = []

    def fake_run(argv, **kw):
        seen.append(argv)
        return subprocess.CompletedProcess(argv, 0, stdout="out\n", stderr="")

    monkeypatch.setattr(t_mcp.subprocess, "run", fake_run)
    resp = t_mcp.handle_request({"jsonrpc": "2.0", "id": 1, "method": "tools/call", "params": {
        "name": "leann_search", "arguments": {"index_name": "idx", "query": "q", "top_k": 3}}}, device="cpu")
    t_mcp.handle_request({"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                          "params": {"name": "leann_list", "arguments": {}}})
    assert resp["result"]["content"] == [{"type": "text", "text": "out"}]
    assert seen == [
        [sys.executable, "-m", "leann_torch.cli", "search", "idx", "q", "--top-k", "3", "--complexity", "64",
         "--non-interactive", "--device", "cpu"],
        [sys.executable, "-m", "leann_torch.cli", "list", "--device", "cuda"]]
    assert "leann_tpu" not in (REPO / "leann_torch" / "mcp.py").read_text()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TINY = ["--embedding-model", "hash-tiny", "--max-length", "64", "-M", "4", "--complexity", "8", "--device", "cpu"]


def _cli(mod, args, capsys):
    rc = mod.main(args)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture()
def project(tmp_path, monkeypatch):
    """A project directory as the current directory, a registry home of its
    own, and a folder of two documents."""
    monkeypatch.setenv("LEANN_HOME", str(tmp_path / "home"))
    proj = tmp_path / "proj"
    docs = proj / "docs"
    docs.mkdir(parents=True)
    (docs / "a.txt").write_text("jupiter is the largest planet in the solar system. " * 5)
    (docs / "b.txt").write_text("the stock market fluctuates based on investor sentiment. " * 5)
    monkeypatch.chdir(proj)
    return proj


def test_cli_build_search_ask_list_remove(project, capsys):
    rc, out, _ = _cli(t_cli, ["build", "demo", "--docs", "docs", *TINY], capsys)
    assert rc == 0 and "2 chunks" in out
    prefix = project / ".leann" / "indexes" / "demo" / "documents.leann"
    assert Path(f"{prefix}.meta.json").exists() and t_cli.find_index("demo") == str(prefix)
    rc, out, _ = _cli(t_cli, ["build", "demo", "--docs", "docs", *TINY], capsys)
    assert rc == 0 and "already exists" in out
    rc, out, _ = _cli(t_cli, ["search", "demo", "largest planet", "--top-k", "1", "--complexity", "8",
                              "--beam-width", "2", "--non-interactive", "--device", "cpu"], capsys)
    assert rc == 0 and out.startswith("[1] (score ") and "jupiter" in out.lower() and "[2]" not in out
    want = leann_torch.LeannSearcher(str(prefix), device="cpu").search("largest planet", top_k=1, complexity=8,
                                                                        beam_width=2)
    assert chip_smoke.parse_search_output(out) == [(round(want[0].score, 4), want[0].text)]
    rc, out, _ = _cli(t_cli, ["ask", "demo", "what is the largest planet?", "--llm", "simulated", "--complexity", "8",
                              "--device", "cpu"], capsys)
    assert rc == 0 and out.startswith("[simulated] Based on the retrieved context: ")
    rc, out, _ = _cli(t_cli, ["list", "--device", "cpu"], capsys)
    assert rc == 0 and "demo" in out and "backend=hnsw" in out
    rc, out, _ = _cli(t_cli, ["remove", "demo", "--force", "--device", "cpu"], capsys)
    assert rc == 0 and not prefix.parent.exists()
    rc, out, _ = _cli(t_cli, ["list", "--device", "cpu"], capsys)
    assert rc == 0 and "demo" not in out
    rc, _, err = _cli(t_cli, ["search", "demo", "q", "--device", "cpu"], capsys)
    assert rc == 1 and "not found" in err


@pytest.mark.parametrize("args", [["build", "demo", "--docs", "docs"], ["search", "demo", "q"], ["ask", "demo", "q"],
                                  ["list"], ["remove", "demo", "--force"], ["repack", "demo"]])
def test_cli_without_device_exits_without_cuda(project, capsys, args):
    """No hidden device: without CUDA, every command exits non-zero with
    resolve_device's message unless it is given --device cpu, and does no
    work."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    rc, out, err = _cli(t_cli, args, capsys)
    assert rc == 1 and "device='cuda' was requested but CUDA is not available" in err and out == ""
    assert not (project / ".leann").exists()


def test_repack_relabel_refuses(project, capsys):
    assert _cli(t_cli, ["build", "demo", "--docs", "docs", *TINY], capsys)[0] == 0
    rc, _, err = _cli(t_cli, ["repack", "demo", "--relabel", "--device", "cpu"], capsys)
    assert rc == 1 and "relabel_index(order=None)" in err and "not ported" in err
    rc, out, _ = _cli(t_cli, ["repack", "demo", "--device", "cpu"], capsys)
    assert rc == 0 and "MB" in out


def test_cli_help_in_a_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), LEANN_HOME=str(tmp_path / "home"))
    out = subprocess.run([sys.executable, "-m", "leann_torch.cli", "--help"], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    for sub in ("build", "search", "ask", "list", "remove", "repack"):
        assert sub in out.stdout
    assert t_cli.build_parser().parse_args(["build", "x", "--docs", "d"]).device == "cuda"


def test_mcp_search_shells_out_to_the_port_cli(project, capsys, monkeypatch):
    """One real shell-out: the MCP tool call runs `python -m leann_torch.cli
    search ... --device cpu` in a child process, whose top result is the
    in-process searcher's."""
    assert _cli(t_cli, ["build", "demo", "--docs", "docs", *TINY], capsys)[0] == 0
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    resp = t_mcp.handle_request({"jsonrpc": "2.0", "id": 7, "method": "tools/call", "params": {
        "name": "leann_search", "arguments": {"index_name": "demo", "query": "stock market", "top_k": 2,
                                              "complexity": 8}}}, device="cpu")
    printed = chip_smoke.parse_search_output(resp["result"]["content"][0]["text"])
    want = leann_torch.LeannSearcher(t_cli.find_index("demo"), device="cpu").search(
        "stock market", top_k=2, complexity=8, beam_width=8)
    assert [p[1] for p in printed] == [r.text for r in want] and "stock market" in printed[0][1]


# ---------------------------------------------------------------------------
# across packages: one package's CLI builds, the other's finds it by name
# and searches it (tests/test_torch_slice.py's bar)
# ---------------------------------------------------------------------------

XPKG_BUILD = ["--embedding-model", "hash-tiny", "--max-length", "64", "-M", "16", "--complexity", "32",
              "--doc-chunk-size", "32", "--doc-chunk-overlap", "0"]
XPKG_KW = dict(top_k=3, complexity=32, beam_width=4)  # tests/test_torch_slice.py's searches
XPKG_FLAGS = ["--top-k", "3", "--complexity", "32", "--beam-width", "4"]


def _ids(results):
    return [[r.id for r in row] for row in results]


def _recall(pred, truth):
    return float(np.mean([len(set(p) & set(t)) / len(t) for p, t in zip(pred, truth)]))


@pytest.fixture(scope="module")
def xpkg(tmp_path_factory):
    """A folder of 240 one-sentence chunks (synth_corpus), built by the JAX
    CLI as "jx", by the port's CLI as "pt", and by the port's CLI as a flat
    oracle, all in one project directory."""
    from scale_500k import synth_corpus

    root = tmp_path_factory.mktemp("xpkg")
    docs = root / "docs"
    docs.mkdir()
    rng = np.random.default_rng(0)
    chunks = synth_corpus(240, rng)
    for f in range(24):
        (docs / f"n{f:02d}.txt").write_text("\n\n".join(c + "." for c in chunks[f * 10:(f + 1) * 10]) + "\n")
    q_idx = rng.choice(len(chunks), 32, replace=False)
    queries = [" ".join(chunks[i].split()[:12]) for i in q_idx]
    prev, prev_home = os.getcwd(), os.environ.get("LEANN_HOME")
    os.chdir(root)
    os.environ["LEANN_HOME"] = str(root / "home")
    try:
        assert j_cli.main(["build", "jx", "--docs", "docs", *XPKG_BUILD]) == 0
        assert t_cli.main(["build", "pt", "--docs", "docs", *XPKG_BUILD, "--device", "cpu"]) == 0
        assert t_cli.main(["build", "oracle", "--docs", "docs", *XPKG_BUILD, "--backend", "flat",
                           "--device", "cpu"]) == 0
    finally:
        os.chdir(prev)
        if prev_home is None:
            os.environ.pop("LEANN_HOME", None)
        else:
            os.environ["LEANN_HOME"] = prev_home
    prefix = {n: str(root / ".leann" / "indexes" / n / "documents.leann") for n in ("jx", "pt", "oracle")}
    truth = _ids(leann_torch.LeannSearcher(prefix["oracle"], device="cpu").search(queries, top_k=3))
    return root, prefix, queries, truth


@pytest.mark.parametrize("built_by,searched_by", [("jax", "torch"), ("torch", "jax")])
def test_cli_index_interchange(xpkg, built_by, searched_by, monkeypatch, capsys):
    root, prefix, queries, truth = xpkg
    name = {"jax": "jx", "torch": "pt"}[built_by]
    monkeypatch.chdir(root)
    monkeypatch.setenv("LEANN_HOME", str(root / "home"))
    other_cli = t_cli if searched_by == "torch" else j_cli
    assert other_cli.find_index(name) == prefix[name]
    args = ["search", name, queries[0], "--non-interactive", *XPKG_FLAGS]
    args += ["--device", "cpu"] if searched_by == "torch" else []
    rc, out, _ = _cli(other_cli, args, capsys)
    searchers = {"torch": leann_torch.LeannSearcher(prefix[name], device="cpu"),
                 "jax": leann_tpu.LeannSearcher(prefix[name])}
    want = searchers[searched_by].search(queries[0], **XPKG_KW)
    assert rc == 0 and [p[1] for p in chip_smoke.parse_search_output(out)] == [r.text for r in want]
    native = _ids(searchers[built_by].search(queries, **XPKG_KW))
    other = _ids(searchers[searched_by].search(queries, **XPKG_KW))
    assert np.mean([set(a) == set(b) for a, b in zip(native, other)]) >= 0.9
    assert abs(_recall(native, truth) - _recall(other, truth)) <= 0.05
    assert _recall(native, truth) >= 0.8


def test_cli_builds_write_the_same_passages(xpkg):
    _, prefix, _, _ = xpkg
    jx, pt = (Path(prefix[n] + ".passages.jsonl").read_bytes() for n in ("jx", "pt"))
    assert jx == pt and len(jx.splitlines()) == 240
    mj, mt = (json.loads(Path(prefix[n] + ".meta.json").read_text()) for n in ("jx", "pt"))
    assert set(mj) == set(mt) and mj["backend_kwargs"] == mt["backend_kwargs"]


# ---------------------------------------------------------------------------
# the two project registries
# ---------------------------------------------------------------------------


def test_registry_homes(tmp_path, monkeypatch, capsys):
    """Each package records its builds in its own home (~/.leann_torch,
    ~/.leann_tpu) unless LEANN_HOME names one for both. The port's CLI finds
    its own builds from any directory, the JAX package's only in the project
    directory or under a shared LEANN_HOME."""
    monkeypatch.delenv("LEANN_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "h"))
    proj, elsewhere = tmp_path / "proj", tmp_path / "elsewhere"
    (proj / "docs").mkdir(parents=True)
    elsewhere.mkdir()
    (proj / "docs" / "a.txt").write_text("alpha beta gamma. delta epsilon zeta. " * 4)
    monkeypatch.chdir(proj)
    assert _cli(t_cli, ["build", "tdemo", "--docs", "docs", *TINY], capsys)[0] == 0
    assert _cli(j_cli, ["build", "jdemo", "--docs", "docs", "--embedding-model", "hash-tiny", "--max-length", "64",
                        "-M", "4", "--complexity", "8"], capsys)[0] == 0
    homes = {pkg: json.loads((tmp_path / "h" / pkg / "projects.json").read_text())["project_directories"]
             for pkg in (".leann_torch", ".leann_tpu")}
    assert [Path(d).name for d in homes[".leann_torch"]] == ["tdemo"]
    assert [Path(d).name for d in homes[".leann_tpu"]] == ["jdemo"]

    def listed(mod):
        return {ln.split()[0] for ln in _cli(mod, ["list"] + (["--device", "cpu"] if mod is t_cli else []),
                                             capsys)[1].splitlines() if "backend=" in ln}

    assert listed(t_cli) == listed(j_cli) == {"tdemo", "jdemo"}  # the project directory
    monkeypatch.chdir(elsewhere)
    assert listed(t_cli) == {"tdemo"}
    assert t_cli.find_index("jdemo") is None and t_cli.find_index("tdemo").endswith("tdemo/documents.leann")
    assert listed(j_cli) == set()  # the JAX package's CLI never looks inside its registry's entries

    monkeypatch.setenv("LEANN_HOME", str(tmp_path / "shared"))
    monkeypatch.chdir(proj)
    assert _cli(t_cli, ["build", "tdemo", "--docs", "docs", "--force", *TINY], capsys)[0] == 0
    assert _cli(j_cli, ["build", "jdemo", "--docs", "docs", "--force", "--embedding-model", "hash-tiny",
                        "--max-length", "64", "-M", "4", "--complexity", "8"], capsys)[0] == 0
    shared = json.loads((tmp_path / "shared" / "projects.json").read_text())["project_directories"]
    assert sorted(Path(d).name for d in shared) == ["jdemo", "tdemo"]
    monkeypatch.chdir(elsewhere)
    assert listed(t_cli) == {"tdemo", "jdemo"}
    assert t_cli.find_index("jdemo").endswith("jdemo/documents.leann")
