"""CoNLL-2005 semantic role labeling (reference:
python/paddle/v2/dataset/conll05.py): a pair of column files (words,
one token per line, a blank line ending a sentence; props, the
predicate lemma and one bracket-tag column per predicate), the bracket
tags turned into BIO, and each (sentence, predicate) pair read as the 8
feature sequences and the label sequence of the SRL model.

Counterpart of paddle_tpu/dataset/conll05.py: the same parser, used
only where the files are already on the machine (or given by path), and
the same synthetic fallback from `common.rng(seed)` (4,000 words, 300
predicates, 59 labels), so it gives the JAX package's samples.
"""

import gzip
import os

from .common import fetch_or_none, rng

__all__ = ["get_dict", "get_embedding", "test", "parse_corpus",
           "reader_creator", "load_dict"]

DATA_URL = ("http://paddlemodels.bj.bcebos.com/conll05st/"
            "conll05st-tests.tar.gz")
DATA_MD5 = "387719152ae52d60422c016e92a742fc"
WORDDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st/"
                "wordDict.txt")
WORDDICT_MD5 = "ea7fb7d4c75cc6254716f0177a506baa"
VERBDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st/"
                "verbDict.txt")
VERBDICT_MD5 = "0d2977293bbb6cbefab5b0f97db1e77c"
TRGDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st/"
               "targetDict.txt")
TRGDICT_MD5 = "d8c7f03ceb5fc2e5a0fa7503a4353751"

UNK_IDX = 0

_SYNTH_WORDS = 4000
_SYNTH_PREDS = 300
_SYNTH_LABELS = 59


def _open_text(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def _brackets_to_bio(tags):
    """One predicate's bracket column -> BIO labels (reference
    conll05.py corpus_reader inner loop: '(A0*' opens, '*)' closes,
    bare '*' continues inside a span or emits O outside one)."""
    bio = []
    current = "O"
    inside = False
    for t in tags:
        if t == "*":
            bio.append("I-" + current if inside else "O")
        elif t == "*)":
            bio.append("I-" + current)
            inside = False
        elif "(" in t:
            current = t[1:t.index("*")]
            bio.append("B-" + current)
            inside = ")" not in t
        else:
            raise ValueError("unexpected conll05 tag %r" % t)
    return bio


def parse_corpus(words_path, props_path):
    """Yield (words, predicate, bio_labels) per (sentence, predicate)."""

    def emit(words, prop_rows):
        predicates = [r[0] for r in prop_rows if r[0] != "-"]
        n_preds = len(prop_rows[0]) - 1
        for k in range(n_preds):
            tags = [r[k + 1] for r in prop_rows]
            yield list(words), predicates[k], _brackets_to_bio(tags)

    def corpus():
        from itertools import zip_longest

        with _open_text(words_path) as wf, _open_text(props_path) as pf:
            words, prop_rows = [], []
            for wline, pline in zip_longest(wf, pf):
                if wline is None or pline is None:
                    raise ValueError(
                        "conll05: words/props files have different "
                        "lengths (%s vs %s)" % (words_path, props_path))
                word = wline.strip()
                cols = pline.strip().split()
                if cols:
                    words.append(word)
                    prop_rows.append(cols)
                    continue
                if prop_rows:  # blank line ends a sentence
                    yield from emit(words, prop_rows)
                words, prop_rows = [], []
            if prop_rows:  # no trailing blank line after last sentence
                yield from emit(words, prop_rows)

    return corpus


def reader_creator(corpus_reader, word_dict, verb_dict, label_dict):
    """The 9-slot SRL sample (reference conll05.py reader_creator):
    words, 5 predicate-context features, predicate, mark, labels."""

    def context(words, i, fallback):
        return words[i] if 0 <= i < len(words) else fallback

    def reader():
        for words, predicate, labels in corpus_reader():
            n = len(words)
            v = labels.index("B-V")
            # the reference marks the 5-token window around the verb
            mark = [0] * n
            for off in (-2, -1, 0, 1, 2):
                if 0 <= v + off < n:
                    mark[v + off] = 1

            def ids(tokens):
                return [word_dict.get(t, UNK_IDX) for t in tokens]

            ctx = {off: context(words, v + off,
                                "bos" if off < 0 else "eos")
                   for off in (-2, -1, 0, 1, 2)}
            yield (ids(words),
                   [word_dict.get(ctx[-2], UNK_IDX)] * n,
                   [word_dict.get(ctx[-1], UNK_IDX)] * n,
                   [word_dict.get(ctx[0], UNK_IDX)] * n,
                   [word_dict.get(ctx[1], UNK_IDX)] * n,
                   [word_dict.get(ctx[2], UNK_IDX)] * n,
                   [verb_dict.get(predicate, UNK_IDX)] * n,
                   mark,
                   [label_dict[l] for l in labels])

    return reader


def load_dict(path):
    """One entry per line -> {entry: line_no}."""
    with _open_text(path) as f:
        return {line.strip(): i for i, line in enumerate(f)}


def _synthetic_dicts():
    word_dict = {("w%d" % i): i for i in range(_SYNTH_WORDS)}
    verb_dict = {("v%d" % i): i for i in range(_SYNTH_PREDS)}
    label_dict = {("l%d" % i): i for i in range(_SYNTH_LABELS)}
    return word_dict, verb_dict, label_dict


def _real_dicts_or_none():
    """(word, verb, label) dicts from the official files, or None."""
    paths = [fetch_or_none(u, "conll05st", m) for u, m in
             ((WORDDICT_URL, WORDDICT_MD5), (VERBDICT_URL, VERBDICT_MD5),
              (TRGDICT_URL, TRGDICT_MD5))]
    if all(p and os.path.exists(p) for p in paths):
        return tuple(load_dict(p) for p in paths)
    return None


def get_dict():
    return _real_dicts_or_none() or _synthetic_dicts()


def build_dicts_from_corpus(corpus_reader):
    """Derive (word, verb, label) dicts from a corpus — the offline
    analog of the reference's downloaded wordDict/verbDict/targetDict
    for user-supplied column files."""
    words, verbs, labels = set(), set(), set()
    for sent, verb, bio in corpus_reader():
        words.update(sent)
        verbs.add(verb)
        labels.update(bio)
    words |= {"bos", "eos"}
    return ({w: i for i, w in enumerate(sorted(words))},
            {v: i for i, v in enumerate(sorted(verbs))},
            {l: i for i, l in enumerate(sorted(labels))})


def get_embedding(word_dict=None, dim=32):
    """Random embedding sized to the dict (the reference downloads a
    trained Wikipedia table; offline a deterministic random one with
    the right row count keeps models shape-correct)."""
    rows = len(word_dict) if word_dict is not None else _SYNTH_WORDS
    return rng(33).uniform(-1, 1, size=(rows, dim)).astype("float32")


def _synthetic_reader(n, seed):
    r = rng(seed)

    def reader():
        for _ in range(n):
            length = int(r.randint(5, 35))
            word = r.randint(0, _SYNTH_WORDS, size=length).tolist()
            pred_idx = int(r.randint(0, length))
            predicate = [int(r.randint(0, _SYNTH_PREDS))] * length
            ctx_n2 = word[max(0, pred_idx - 2):][:1] * length
            ctx_n1 = word[max(0, pred_idx - 1):][:1] * length
            ctx_0 = [word[pred_idx]] * length
            ctx_p1 = word[min(length - 1, pred_idx + 1):][:1] * length
            ctx_p2 = word[min(length - 1, pred_idx + 2):][:1] * length
            mark = [1 if i == pred_idx else 0 for i in range(length)]
            label = r.randint(0, _SYNTH_LABELS, size=length).tolist()
            yield (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
                   predicate, mark, label)

    return reader


def _extracted_corpus_paths():
    """Download + extract the official test tarball when allowed;
    returns (words_path, props_path) or None."""
    tar_path = fetch_or_none(DATA_URL, "conll05st", DATA_MD5)
    if not tar_path or not os.path.exists(tar_path):
        return None
    import tarfile

    root = os.path.dirname(tar_path)
    words = os.path.join(root, "conll05st-release/test.wsj/words/"
                               "test.wsj.words.gz")
    props = os.path.join(root, "conll05st-release/test.wsj/props/"
                               "test.wsj.props.gz")
    if not (os.path.exists(words) and os.path.exists(props)):
        with tarfile.open(tar_path) as tf:
            try:
                tf.extractall(root, filter="data")  # no ../ escapes
            except TypeError:  # filter= requires python >= 3.11.4
                tf.extractall(root)
    if os.path.exists(words) and os.path.exists(props):
        return words, props
    return None


def test(words_path=None, props_path=None, dicts=None):
    """Real column files (explicit paths, or the downloaded official
    tarball when PADDLE_TPU_ALLOW_DOWNLOAD=1); synthetic otherwise.
    Without `dicts`, dictionaries come from the downloaded dict files
    or are derived from the corpus itself."""
    explicit = words_path is not None or props_path is not None
    if explicit:
        for p in (words_path, props_path):
            if not p or not os.path.exists(p):
                raise FileNotFoundError(
                    "conll05: explicit corpus path %r does not exist"
                    % (p,))
    else:
        found = _extracted_corpus_paths()
        if found:
            words_path, props_path = found
    if words_path and props_path:
        corpus = parse_corpus(words_path, props_path)
        if dicts is None:
            # never pair a real corpus with the synthetic dict fallback
            # (its keys aren't BIO tags -> KeyError mid-read).  Prefer
            # the official dicts — ids then agree with models trained
            # against get_dict() — but only when they actually cover
            # this corpus's labels; otherwise derive from the corpus.
            derived = build_dicts_from_corpus(corpus)
            official = _real_dicts_or_none()
            if official is not None and \
                    set(derived[2]) <= set(official[2]):
                dicts = official
            else:
                dicts = derived
        word_dict, verb_dict, label_dict = dicts
        return reader_creator(corpus, word_dict, verb_dict, label_dict)
    return _synthetic_reader(256, 44)
