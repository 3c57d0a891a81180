"""A directory whose only tokenizer file is a SentencePiece
``sentencepiece.bpe.model`` (XLM-R, CamemBERT), read by leann_torch's own
ModelProto reader and converted as ``transformers`` converts it, against
``transformers``' own conversion (CPU).

The fixtures: a Unigram trained here with ``tokenizers`` on the corpus, with
the head pieces of fairseq's SentencePiece models (``<unk>`` of type
unknown, ``<s>`` and ``</s>`` of type control), written as a ``ModelProto``
through ``transformers``' own ``sentencepiece_model_pb2`` module; varied
with and without a darts-clone ``precompiled_charsmap``, with
``add_dummy_prefix`` on and off, and with control and user-defined pieces
added.

The reference: ``transformers.convert_slow_tokenizer``'s
``XLMRobertaConverter`` / ``CamembertConverter`` run on the file (they need
only protobuf; ``sentencepiece`` is not installed here), given a stand-in
for the slow tokenizer that carries ``vocab_file`` and the slow class's
``convert_tokens_to_ids`` rule, copied from
``transformers/models/xlm_roberta/tokenization_xlm_roberta.py``
(``_convert_token_to_id``: ``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, ``<unk>`` 3,
else the piece's id + 1, its unknown id for piece 0) and
``models/camembert/tokenization_camembert.py:140-188`` (``4 +`` the
piece's id, its unknown id 3 for piece 0). The converted pipeline is wrapped
in ``XLMRobertaTokenizerFast`` / ``CamembertTokenizerFast(tokenizer_object=
...)`` and saved to a twin directory, which the JAX package's HFTokenizer
(``AutoTokenizer``) reads. The port reads the ``.model``-only directory.
Ids and masks must be equal on the cases and on a hypothesis fuzz at
``max_length`` 8 and 64, also with ``transformers``, ``tokenizers`` and
protobuf blocked. A BPE-type model and a class outside XLM-R and CamemBERT
raise ``not_ported``; where a directory holds several slow files, its class
picks the one it reads.
"""

import builtins
import json
import os
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("google.protobuf")

from transformers.convert_slow_tokenizer import import_protobuf  # noqa: E402

from leann_torch.embeddings import spm_model as sm  # noqa: E402
from leann_torch.embeddings import tokenizer as tt  # noqa: E402

from test_torch_tokenizer_json import ALPHABET, CASES, CORPUS, PRECOMPILED_RULES, _check, darts_blob  # noqa: E402

SPM = "sentencepiece.bpe.model"
CONVERTERS = {"XLMRobertaTokenizer": ("XLMRobertaConverter", "XLMRobertaTokenizerFast"),
              "CamembertTokenizer": ("CamembertConverter", "CamembertTokenizerFast")}
# kind -> (class, precompiled charsmap, add_dummy_prefix, extra (piece, type) pairs, how the class is named)
KINDS = {
    "xlmr": ("XLMRobertaTokenizer", True, True, (), "tokenizer_config"),
    "xlmr_plain_no_prefix": ("XLMRobertaTokenizer", False, False, (), "tokenizer_config"),
    "xlmr_user_control": ("XLMRobertaTokenizer", True, True, (("<ctl>", 3), ("▁w22", 4), ("zq", 4)),
                          "model_type"),
    "camembert": ("CamembertTokenizer", True, True, (), "model_type"),
    "camembert_plain_user_control": ("CamembertTokenizer", False, False, (("<ctl>", 3), ("zq", 4)),
                                     "tokenizer_config"),
}
MODEL_TYPE = {"XLMRobertaTokenizer": "xlm-roberta", "CamembertTokenizer": "camembert"}


def _trained_pieces():
    u = tokenizers.SentencePieceUnigramTokenizer()
    u.train_from_iterator(CORPUS * 20, vocab_size=400, special_tokens=["<unk>", "<s>", "</s>"], unk_token="<unk>",
                          show_progress=False)
    return json.loads(u._tokenizer.to_str())["model"]["vocab"]


def write_model(path, pieces, charsmap, dummy_prefix, extra=(), model_type=1, rules=PRECOMPILED_RULES):
    """A ModelProto through transformers' protobuf module: ``pieces``
    ([piece, score]) with fairseq's head types, then ``extra`` (piece,
    type) at score 0; with ``charsmap``, ``rules`` as its
    ``precompiled_charsmap``."""
    pb = import_protobuf()
    m = pb.ModelProto()
    for i, (piece, score) in enumerate(list(pieces) + [[p, 0.0] for p, _ in extra]):
        p = m.pieces.add()
        p.piece, p.score = piece, score
        p.type = 2 if i == 0 else 3 if piece in ("<s>", "</s>") else dict(extra).get(piece, 1)
    m.trainer_spec.model_type = model_type
    m.trainer_spec.unk_id = 0
    m.trainer_spec.vocab_size = len(m.pieces)
    m.normalizer_spec.name = "nmt_nfkc" if charsmap else "identity"
    if charsmap:
        m.normalizer_spec.precompiled_charsmap = darts_blob(rules)
    m.normalizer_spec.add_dummy_prefix = dummy_prefix
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    return m


class StandIn:
    """What the converters read of the slow tokenizer: its ``vocab_file``
    and ``convert_tokens_to_ids``, by the slow class's rule."""

    def __init__(self, vocab_file, cls_name, pieces):
        self.vocab_file, self.cls_name = vocab_file, cls_name
        self.piece_ids = {p: i for i, (p, _) in enumerate(pieces)}

    def convert_tokens_to_ids(self, token):
        spm_id = self.piece_ids.get(token, 0)
        if self.cls_name == "XLMRobertaTokenizer":
            fairseq = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
            return fairseq[token] if token in fairseq else (spm_id + 1 if spm_id else 3)
        return 4 + spm_id if spm_id else 3


def _directories(root, pieces, kind):
    cls_name, charsmap, dummy, extra, named_by = KINDS[kind]
    model_dir, twin = root / kind, root / f"{kind}_twin"
    model_dir.mkdir()
    file = str(model_dir / SPM)
    m = write_model(file, pieces, charsmap, dummy, extra)
    if named_by == "tokenizer_config":
        (model_dir / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": cls_name}))
    else:
        (model_dir / "config.json").write_text(json.dumps({"model_type": MODEL_TYPE[cls_name]}))
    conv_name, fast_name = CONVERTERS[cls_name]
    stand_in = StandIn(file, cls_name, [(p.piece, p.score) for p in m.pieces])
    backend = getattr(transformers.convert_slow_tokenizer, conv_name)(stand_in).converted()
    getattr(transformers, fast_name)(tokenizer_object=backend).save_pretrained(str(twin))
    return str(model_dir), str(twin)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spm")
    pieces = _trained_pieces()
    return {kind: _directories(root, pieces, kind) for kind in KINDS}


@pytest.fixture(scope="module")
def readers(dirs):
    from leann_tpu.embeddings.tokenizer import HFTokenizer as JaxHF

    tt._TOKENIZER_CACHE.clear()
    return {k: (tt.get_tokenizer(d, max_length=64), JaxHF(twin)) for k, (d, twin) in dirs.items()}


def test_reader_equals_protobuf(dirs):
    """Every field the reader takes, against protobuf's own parse."""
    pb = import_protobuf()
    for kind, (d, _) in dirs.items():
        with open(os.path.join(d, SPM), "rb") as f:
            data = f.read()
        want = pb.ModelProto()
        want.ParseFromString(data)
        got = sm.read_model_proto(data)
        assert [(p.piece, p.score, p.type) for p in got.pieces] == [(p.piece, p.score, p.type) for p in want.pieces]
        assert (got.model_type, got.precompiled_charsmap) == (want.trainer_spec.model_type,
                                                              want.normalizer_spec.precompiled_charsmap)
    m = pb.ModelProto()
    m.trainer_spec.unk_id, m.trainer_spec.byte_fallback, m.trainer_spec.model_type = -1, True, 2
    m.self_test_data.samples.add().input = "skipped"
    got = sm.read_model_proto(m.SerializeToString())
    assert (got.pieces, got.model_type, got.precompiled_charsmap) == ([], 2, b"")


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("max_length", [8, 64])
def test_cases_equal_the_converted_tokenizer(readers, kind, max_length):
    ours, jax = readers[kind]
    assert isinstance(ours, tt.SpmTokenizer) and ours.tokenizer_class == KINDS[kind][0]
    texts = CASES + CORPUS + ["a <ctl> zq w22", "x<s>NOTUSED y", "<unk>NOTUSED"]
    _check(ours.encode_batch(texts, max_length), jax.encode_batch(texts, max_length), texts)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.lists(st.sampled_from(ALPHABET + ["<ctl>", "zq", "NOTUSED"]), max_size=30).map("".join),
                min_size=1, max_size=5))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("max_length", [8, 64])
def test_fuzz_equals_the_converted_tokenizer(readers, kind, max_length, texts):
    ours, jax = readers[kind]
    _check(ours.encode_batch(texts, max_length), jax.encode_batch(texts, max_length), texts)


@pytest.mark.parametrize("kind", ["xlmr", "camembert"])
def test_reads_without_transformers_or_protobuf(dirs, readers, kind, monkeypatch):
    """transformers, tokenizers, protobuf and sentencepiece unimportable,
    as on the card's machine."""
    real_import = builtins.__import__
    blocked = ("transformers", "tokenizers", "google", "sentencepiece")

    def guarded(name, *a, **kw):
        if name.split(".")[0] in blocked:
            raise ImportError(f"{name} is blocked in this test")
        return real_import(name, *a, **kw)

    for mod in [m for m in sys.modules if m.split(".")[0] in blocked]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", guarded)
    monkeypatch.setattr(tt, "_TOKENIZER_CACHE", {})
    tok = tt.get_tokenizer(dirs[kind][0], max_length=64)
    for L in (8, 64):
        _check(tok.encode_batch(CASES, L), readers[kind][0].encode_batch(CASES, L), CASES)


def test_special_ids_follow_the_slow_class(readers):
    """XLM-R's fairseq ids; CamemBERT's 4 + the piece's id (<s> 5, </s>
    6), its unknown 3 and <unk>NOTUSED 4; both pad with 1 and end with
    <mask>."""
    x, c = readers["xlmr"][0], readers["camembert"][0]
    assert (x.before, x.after, x.pad_id, x.unk_id) == ([0], [2], 1, 3)
    assert (c.before, c.after, c.pad_id, c.unk_id) == ([5], [6], 1, 3)
    assert c.token_to_id("<unk>NOTUSED") == 4 and x.token_to_id("<mask>") == x.vocab_size - 1
    assert c.token_to_id("<mask>") == c.vocab_size - 1


def test_bpe_model_and_other_classes_raise(tmp_path):
    pieces = [["<unk>", 0.0], ["<s>", 0.0], ["</s>", 0.0], ["▁a", -1.0], ["b", -2.0]]
    bpe = tmp_path / "bpe"
    bpe.mkdir()
    write_model(str(bpe / SPM), pieces, False, True, model_type=2)
    (bpe / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "XLMRobertaTokenizer"}))
    with pytest.raises(NotImplementedError, match=r"BPE type.*§A #4"):
        tt.get_tokenizer(str(bpe))
    for name, fname, cfg in (("t5", "spiece.model", {"tokenizer_class": "T5Tokenizer"}),
                             ("albert", "spiece.model", {"model_type": "albert"}),
                             ("xlmr_spiece", "spiece.model", {"tokenizer_class": "XLMRobertaTokenizer"}),
                             ("noclass", SPM, {})):
        d = tmp_path / name
        d.mkdir()
        write_model(str(d / fname), pieces, False, True)
        (d / ("config.json" if "model_type" in cfg else "tokenizer_config.json")).write_text(json.dumps(cfg))
        with pytest.raises(NotImplementedError, match=r"not ported.*§A #4"):
            tt.get_tokenizer(str(d))
    word = tmp_path / "word"
    word.mkdir()
    write_model(str(word / SPM), pieces, False, True, model_type=3)
    (word / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "CamembertTokenizer"}))
    with pytest.raises(ValueError, match="only Unigram and BPE"):
        tt.get_tokenizer(str(word))


def test_the_class_picks_among_slow_files(dirs, tmp_path):
    """A directory with a sentencepiece model, a vocab.txt and vocab.json +
    merges.txt: CamemBERT reads the model, BERT and ELECTRA the vocab.txt,
    RoBERTa the BPE files; tokenizer.json comes before all of them."""
    src = os.path.join(dirs["camembert"][0], SPM)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "b"]
    want = {"CamembertTokenizer": tt.SpmTokenizer, "BertTokenizer": tt.HFTokenizer,
            "ElectraTokenizer": tt.HFTokenizer, "RobertaTokenizer": tt.BpeFilesTokenizer}
    for cls_name, reader in want.items():
        d = tmp_path / cls_name
        d.mkdir()
        (d / SPM).write_bytes(open(src, "rb").read())
        (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
        (d / "vocab.json").write_text(json.dumps({"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "a": 4}))
        (d / "merges.txt").write_text("#version: 0.2\n")
        (d / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": cls_name + "Fast"}))
        tok = tt.get_tokenizer(str(d))
        assert type(tok) is reader and tok.tokenizer_class == cls_name
    twin = dirs["camembert"][1]
    assert type(tt.get_tokenizer(twin)).__name__ == "JsonTokenizer"
    ids = tt.get_tokenizer(twin).encode_batch(CASES, 64)[0]
    assert np.array_equal(ids, tt.get_tokenizer(dirs["camembert"][0]).encode_batch(CASES, 64)[0])


def test_the_smokes_model_file(tmp_path):
    """chip_smoke.py writes its CamemBERT ``.model`` in protobuf's wire
    format by hand (the card's machine has no protobuf): protobuf parses it
    to the same pieces and fields, transformers' converter and the port read
    it alike, no corpus word is <unk>, the ``tokenizer.json`` the smoke
    writes as the converter's output is the converter's (its components
    equal, its ids equal), and the smoke's host-only twins agree."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    d = tmp_path / "cam"
    d.mkdir()
    info = cs.camembert_tokenizer_files(str(d), 2000)
    data = (d / SPM).read_bytes()
    pb = import_protobuf()
    m = pb.ModelProto()
    m.ParseFromString(data)
    assert len(m.pieces) == info["pieces"] == 2000 and m.normalizer_spec.precompiled_charsmap
    assert [(p.piece, p.score, p.type) for p in sm.read_model_proto(data).pieces] == [
        (p.piece, p.score, p.type) for p in m.pieces]
    stand_in = StandIn(str(d / SPM), "CamembertTokenizer", [(p.piece, p.score) for p in m.pieces])
    twin = str(tmp_path / "twin")
    transformers.CamembertTokenizerFast(
        tokenizer_object=transformers.convert_slow_tokenizer.CamembertConverter(stand_in).converted()
    ).save_pretrained(twin)
    from leann_tpu.embeddings.tokenizer import HFTokenizer as JaxHF

    chunks = cs.synth_corpus(300, np.random.default_rng(0))
    texts = chunks + CASES + ["Ａ ﬁ é", "w49999 g1234a d77x"]
    ours = tt.get_tokenizer(str(d), max_length=128)
    _check(ours.encode_batch(texts, 128), JaxHF(twin).encode_batch(texts, 128), texts)
    ids, mask = ours.encode_batch(chunks, 128)
    assert not (ids[mask.astype(bool)] == ours.unk_id).any()
    assert ours.normalizer("Ａ ﬁ é") == "A fi é"
    written = tmp_path / "written"
    written.mkdir()
    cs.camembert_tokenizer_json(str(written), 2000)
    got, want = (json.loads(open(os.path.join(p, "tokenizer.json"), encoding="utf-8").read()) for p in (written, twin))
    for key in ("added_tokens", "normalizer", "pre_tokenizer", "model"):
        assert got[key] == want[key], key
    for key in ("single", "special_tokens"):
        assert got["post_processor"][key] == want["post_processor"][key], key
    _check(JaxHF(str(written)).encode_batch(texts, 128), JaxHF(twin).encode_batch(texts, 128), texts)
    twins = cs.tokenizer_twins(str(tmp_path), str(d), chunks[:100], 2000)
    assert all(t["equal"] for t in twins.values()) and twins["bpe_files_vs_tokenizer_json"]["reader"] == \
        "BpeFilesTokenizer"
