"""Text datasets (counterpart of paddle_tpu/text/datasets.py, bit for bit;
ref: python/paddle/text/datasets/ — Imdb, Imikolov,
UCIHousing, Conll05, Movielens … backed by paddle/dataset/ downloaders).

Nothing is downloaded: each dataset loads from a local ``data_file``
when provided (the reference's on-disk formats where cheap: IMDB aclImdb
tar layout, Imikolov token files, UCI housing whitespace table) and otherwise
falls back to a deterministic synthetic corpus, keeping e2e tests hermetic
(same policy as vision/datasets.py).  Items are numpy, as there.
"""
from __future__ import annotations

import os
import tarfile
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..io.dataset import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Conll05st",
           "Movielens", "WMT14", "WMT16", "MovieReviews"]


def _tokenize(text: str) -> List[str]:
    out, cur = [], []
    for ch in text.lower():
        if ch.isalnum():
            cur.append(ch)
        elif cur:
            out.append("".join(cur))
            cur = []
    if cur:
        out.append("".join(cur))
    return out


class Imdb(Dataset):
    """IMDB sentiment (ref text/datasets/imdb.py): sequences of word ids +
    binary label, padded to ``maxlen`` with 0 (static shapes)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150, maxlen: int = 256,
                 synthetic_size: int = 512):
        self.mode = mode
        self.maxlen = maxlen
        if data_file and os.path.exists(data_file):
            docs, labels = self._load_tar(data_file, mode)
            self.word_idx = self._build_dict(docs, cutoff)
            seqs = [[self.word_idx.get(w, len(self.word_idx)) for w in d]
                    for d in docs]
        else:
            rng = np.random.RandomState(0 if mode == "train" else 1)
            vocab = 5000
            self.word_idx = {f"w{i}": i for i in range(vocab)}
            seqs, labels = [], []
            for i in range(synthetic_size):
                label = int(rng.rand() > 0.5)
                L = int(rng.randint(8, maxlen))
                # class-dependent token distribution so models can learn
                base = rng.randint(0, vocab // 2, size=L)
                seqs.append((base + label * vocab // 2).tolist())
                labels.append(label)
        self.docs = [self._pad(s) for s in seqs]
        self.labels = np.asarray(labels, np.int64)

    def _pad(self, seq):
        out = np.zeros(self.maxlen, np.int64)
        s = np.asarray(seq[:self.maxlen], np.int64)
        out[:len(s)] = s
        return out

    @staticmethod
    def _load_tar(path, mode):
        docs, labels = [], []
        pat_pos = f"aclImdb/{mode}/pos/"
        pat_neg = f"aclImdb/{mode}/neg/"
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if member.name.startswith(pat_pos) or member.name.startswith(pat_neg):
                    f = tf.extractfile(member)
                    if f is None:
                        continue
                    docs.append(_tokenize(f.read().decode("utf-8", "ignore")))
                    labels.append(1 if pat_pos in member.name else 0)
        return docs, labels

    @staticmethod
    def _build_dict(docs, cutoff):
        freq = {}
        for d in docs:
            for w in d:
                freq[w] = freq.get(w, 0) + 1
        words = [w for w, c in sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
                 if c > cutoff]
        return {w: i for i, w in enumerate(words)}

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB-style n-gram LM dataset (ref text/datasets/imikolov.py):
    each item is (context ids [N-1], next id)."""

    def __init__(self, data_file: Optional[str] = None, data_type: str = "NGRAM",
                 window_size: int = 5, mode: str = "train",
                 min_word_freq: int = 50, synthetic_size: int = 2048):
        self.window_size = window_size
        if data_file and os.path.exists(data_file):
            with open(data_file, encoding="utf-8") as f:
                tokens = _tokenize(f.read())
            freq = {}
            for t in tokens:
                freq[t] = freq.get(t, 0) + 1
            vocab = [w for w, c in sorted(freq.items(),
                                          key=lambda kv: (-kv[1], kv[0]))
                     if c >= min_word_freq]
            self.word_idx = {w: i for i, w in enumerate(vocab)}
            unk = len(self.word_idx)
            ids = [self.word_idx.get(t, unk) for t in tokens]
        else:
            rng = np.random.RandomState(2 if mode == "train" else 3)
            vocab_n = 2000
            self.word_idx = {f"w{i}": i for i in range(vocab_n)}
            # markov-ish synthetic stream: next ≈ (prev*7+3) mod vocab + noise
            ids = [int(rng.randint(vocab_n))]
            for _ in range(synthetic_size + window_size):
                nxt = (ids[-1] * 7 + 3 + int(rng.randint(0, 3))) % vocab_n
                ids.append(nxt)
        w = window_size
        self.samples = [(np.asarray(ids[i:i + w - 1], np.int64),
                         np.int64(ids[i + w - 1]))
                        for i in range(len(ids) - w + 1)]

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class UCIHousing(Dataset):
    """Boston-housing regression (ref text/datasets/uci_housing.py):
    13 normalized features -> price."""

    FEATURE_DIM = 13

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 synthetic_size: int = 506):
        if data_file and os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype(np.float32)
            feats, prices = raw[:, :-1], raw[:, -1:]
        else:
            rng = np.random.RandomState(4 if mode == "train" else 5)
            feats = rng.rand(synthetic_size, self.FEATURE_DIM).astype(np.float32)
            w = np.linspace(-2, 2, self.FEATURE_DIM, dtype=np.float32)
            prices = (feats @ w[:, None] + 3.0 +
                      rng.randn(synthetic_size, 1).astype(np.float32) * 0.1)
        mean, std = feats.mean(0), feats.std(0) + 1e-8
        self.features = (feats - mean) / std
        self.prices = prices.astype(np.float32)
        split = int(0.8 * len(self.features))
        if mode == "train":
            self.features, self.prices = self.features[:split], self.prices[:split]
        else:
            self.features, self.prices = self.features[split:], self.prices[split:]

    def __getitem__(self, idx):
        return self.features[idx], self.prices[idx]

    def __len__(self):
        return len(self.features)


class Conll05st(Dataset):
    """CoNLL-2005 semantic role labeling (ref text/datasets/conll05.py /
    paddle/dataset/conll05.py): each item is the reference's 9-slot tuple
    (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark,
    label_ids), all padded to ``maxlen`` (dense analogue of the LoD
    sequences the label_semantic_roles book model consumes).

    Nothing is downloaded: loads the reference's column text format (word
    predicate ...  label per line, blank line between sentences) from
    ``data_file`` when given, else a deterministic synthetic corpus whose
    labels are a learnable function of word/predicate (BIO over 5
    roles)."""

    N_LABELS = 2 * 5 + 1  # B-*/I-* for 5 roles + O, reference label scheme

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 maxlen: int = 64, synthetic_size: int = 256):
        self.maxlen = maxlen
        if data_file and os.path.exists(data_file):
            all_sents = self._load_columns(data_file)
            # dictionaries come from the WHOLE corpus so train/test share
            # id mappings and n_labels; only the samples split 80/20
            sents = all_sents
            words = sorted({w for s in sents for w in s["words"]})
            self.word_dict = {w: i for i, w in enumerate(words)}
            preds = sorted({s["pred"] for s in sents})
            self.predicate_dict = {p: i for i, p in enumerate(preds)}
            # "O" (outside) goes LAST: it is also the pad fill, and models
            # size their label head from ds.n_labels
            labels = sorted({l for s in sents for l in s["labels"]}
                            - {"O"}) + ["O"]
            self.label_dict = {l: i for i, l in enumerate(labels)}
            self.n_labels = len(labels)
            samples = [
                ([self.word_dict[w] for w in s["words"]],
                 self.predicate_dict[s["pred"]], s["pred_pos"],
                 [self.label_dict[l] for l in s["labels"]])
                for i, s in enumerate(all_sents)
                if (i % 5 != 4) == (mode == "train")]
        else:
            rng = np.random.RandomState(4 if mode == "train" else 5)
            vocab, n_pred = 800, 60
            self.word_dict = {f"w{i}": i for i in range(vocab)}
            self.predicate_dict = {f"p{i}": i for i in range(n_pred)}
            self.label_dict = {i: i for i in range(self.N_LABELS)}
            self.n_labels = self.N_LABELS
            samples = []
            for _ in range(synthetic_size):
                L = int(rng.randint(8, maxlen))
                words = rng.randint(0, vocab, L)
                pred_pos = int(rng.randint(0, L))
                pred = int(words[pred_pos]) % n_pred
                # learnable labels: role depends on distance to predicate
                labels = np.full(L, self.N_LABELS - 1)  # O
                for d, role in ((1, 0), (2, 1), (3, 2)):
                    if pred_pos + d < L:
                        labels[pred_pos + d] = 2 * role  # B-role
                samples.append((words.tolist(), pred, pred_pos,
                                labels.tolist()))
        self.samples = [self._featurize(*s) for s in samples]

    def _featurize(self, word_ids, pred_id, pred_pos, label_ids):
        m = self.maxlen
        L = min(len(word_ids), m)

        def pad(seq, fill=0):
            out = np.full(m, fill, np.int64)
            out[:L] = np.asarray(seq[:L], np.int64)
            return out

        words = pad(word_ids)
        # predicate context window columns (ref ctx_n2..ctx_p2)
        ctx = []
        for off in (-2, -1, 0, 1, 2):
            p = min(max(pred_pos + off, 0), L - 1)
            ctx.append(np.full(m, word_ids[p] if word_ids else 0, np.int64))
        mark = np.zeros(m, np.int64)
        if pred_pos < m:
            mark[pred_pos] = 1
        return (words, *ctx, np.full(m, pred_id, np.int64), mark,
                pad(label_ids, fill=self.n_labels - 1))  # fill = "O"

    @staticmethod
    def _load_columns(path):
        sents, words, labels = [], [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    if words:
                        pred_pos = next(
                            (i for i, l in enumerate(labels) if l == "B-V"),
                            0)
                        sents.append(dict(words=words, labels=labels,
                                          pred=words[pred_pos],
                                          pred_pos=pred_pos))
                        words, labels = [], []
                    continue
                cols = line.split()
                words.append(cols[0])
                labels.append(cols[-1])
        if words:
            pred_pos = next((i for i, l in enumerate(labels) if l == "B-V"),
                            0)
            sents.append(dict(words=words, labels=labels,
                              pred=words[pred_pos], pred_pos=pred_pos))
        return sents

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class Movielens(Dataset):
    """MovieLens-1M rating prediction (ref text/datasets/movielens.py):
    item = (user_id, gender_id, age_id, job_id, movie_id, category_ids
    [padded], title_ids [padded], rating) — the recommender_system book
    model's input contract."""

    N_AGES, N_JOBS, N_CATEGORIES = 7, 21, 18

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 title_len: int = 8, n_users: int = 400, n_movies: int = 500,
                 synthetic_size: int = 2048):
        self.title_len = title_len
        if data_file and os.path.exists(data_file):
            samples = self._load_ml1m(data_file)
            # deterministic 80/20 train/test split
            self.samples = [x for i, x in enumerate(samples)
                            if (i % 5 != 4) == (mode == "train")]
            return
        rng = np.random.RandomState(6 if mode == "train" else 7)
        self.samples = []
        user_feat = rng.randn(n_users)
        movie_feat = rng.randn(n_movies)
        for _ in range(synthetic_size):
            u = int(rng.randint(n_users))
            m = int(rng.randint(n_movies))
            cats = rng.randint(0, self.N_CATEGORIES, 3).astype(np.int64)
            title = rng.randint(1, 1000, self.title_len)
            # learnable rating: affinity of user/movie latent features
            r = 3.0 + 1.5 * np.tanh(user_feat[u] * movie_feat[m])
            self.samples.append((
                np.int64(u), np.int64(rng.randint(2)),
                np.int64(rng.randint(self.N_AGES)),
                np.int64(rng.randint(self.N_JOBS)), np.int64(m),
                cats, title.astype(np.int64),
                np.float32(np.clip(round(r), 1, 5))))

    def _load_ml1m(self, path):
        import zipfile

        samples = []
        users, movies = {}, {}
        with zipfile.ZipFile(path) as zf:
            base = next((n.split("/")[0] for n in zf.namelist()
                         if n.endswith("users.dat")), "ml-1m")
            ages = {1: 0, 18: 1, 25: 2, 35: 3, 45: 4, 50: 5, 56: 6}
            for line in zf.read(f"{base}/users.dat").decode(
                    "latin1").splitlines():
                uid, gender, age, job, _ = line.split("::")
                users[int(uid)] = (int(gender == "M"),
                                   ages.get(int(age), 0), int(job))
            cat_ids: dict = {}
            for line in zf.read(f"{base}/movies.dat").decode(
                    "latin1").splitlines():
                mid, title, cats = line.split("::")
                ids = [cat_ids.setdefault(c, len(cat_ids))
                       for c in cats.split("|")]
                # salted hash() varies across processes; crc32 keeps
                # title ids stable between train and eval runs
                t = [zlib.crc32(w.encode()) % 5000 + 1
                     for w in title.split()[:self.title_len]]
                movies[int(mid)] = (ids, t)
            for line in zf.read(f"{base}/ratings.dat").decode(
                    "latin1").splitlines():
                uid, mid, rating, _ = line.split("::")
                uid, mid = int(uid), int(mid)
                if uid not in users or mid not in movies:
                    continue
                g, a, j = users[uid]
                ids, t = movies[mid]
                cats = np.zeros(3, np.int64)
                cats[:len(ids[:3])] = ids[:3]
                title = np.zeros(self.title_len, np.int64)
                title[:len(t)] = t
                samples.append((np.int64(uid), np.int64(g), np.int64(a),
                                np.int64(j), np.int64(mid), cats, title,
                                np.float32(rating)))
        return samples

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class _WMTBase(Dataset):
    """Shared seq2seq dataset shape (ref datasets/wmt14.py / wmt16.py):
    item = (src_ids, trg_ids, trg_next) padded to ``maxlen``; ids 0/1/2 =
    <s>/<e>/<unk>, the reference's special-token convention."""

    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 src_dict_size: int = 1000, trg_dict_size: int = 1000,
                 maxlen: int = 32, synthetic_size: int = 512, seed: int = 8):
        self.maxlen = maxlen
        pairs = None
        if data_file and os.path.exists(data_file):
            pairs = self._load_pairs(data_file)
            if pairs is not None:  # deterministic 80/20 train/test split
                pairs = [x for i, x in enumerate(pairs)
                         if (i % 5 != 4) == (mode == "train")]
        if pairs is None:
            rng = np.random.RandomState(seed if mode == "train" else seed + 1)
            pairs = []
            for _ in range(synthetic_size):
                L = int(rng.randint(4, maxlen - 2))
                src = rng.randint(3, src_dict_size, L)
                # learnable toy translation: reversed + shifted mod vocab
                trg = ((src[::-1] + 7) % (trg_dict_size - 3)) + 3
                pairs.append((src.tolist(), trg.tolist()))
        self.samples = [self._featurize(s, t) for s, t in pairs]

    def _featurize(self, src, trg):
        m = self.maxlen

        def pad(seq):
            out = np.full(m, self.EOS, np.int64)
            s = np.asarray(seq[:m], np.int64)
            out[:len(s)] = s
            return out

        trg_in = [self.BOS] + list(trg[:m - 1])
        trg_next = list(trg[:m - 1]) + [self.EOS]
        return pad(src), pad(trg_in), pad(trg_next)

    @staticmethod
    def _load_pairs(path):
        """Tab-separated 'src<TAB>trg' lines of integer ids."""
        pairs = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 2:
                    continue
                pairs.append(([int(t) for t in parts[0].split()],
                              [int(t) for t in parts[1].split()]))
        return pairs or None

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class WMT14(_WMTBase):
    """ref text/datasets/wmt14.py (EN→FR)."""


class WMT16(_WMTBase):
    """ref text/datasets/wmt16.py (multi-lingual); same padded contract."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 src_lang: str = "en", trg_lang: str = "de", **kw):
        del src_lang, trg_lang  # synthetic corpus is language-agnostic
        super().__init__(data_file, mode, seed=10, **kw)


class MovieReviews(Dataset):
    """NLTK movie-review sentiment (ref text/datasets/movie_reviews.py /
    paddle/dataset/sentiment.py): (padded token ids, polarity)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 maxlen: int = 128, synthetic_size: int = 512):
        if data_file and os.path.exists(data_file):
            # NLTK layout: <root>/pos/*.txt, <root>/neg/*.txt (no aclImdb/
            # mode prefix) — split 80/20 deterministically by member order
            self.maxlen = maxlen
            docs, labels = [], []
            with tarfile.open(data_file) as tf:
                members = [m for m in tf.getmembers()
                           if "/pos/" in m.name or "/neg/" in m.name]
                members.sort(key=lambda m: m.name)
                for i, member in enumerate(members):
                    if (i % 5 != 4) != (mode == "train"):
                        continue
                    f = tf.extractfile(member)
                    if f is None:
                        continue
                    docs.append(_tokenize(f.read().decode("utf-8",
                                                          "ignore")))
                    labels.append(1 if "/pos/" in member.name else 0)
            if not docs:
                raise ValueError(
                    f"no /pos/ or /neg/ members found in {data_file!r} "
                    "(expected the NLTK movie_reviews tar layout)")
            self.word_idx = Imdb._build_dict(docs, cutoff=2)
            unk = len(self.word_idx)
            pad = Imdb._pad.__get__(self)
            self.docs = [pad([self.word_idx.get(w, unk) for w in d])
                         for d in docs]
            self.labels = np.asarray(labels, np.int64)
            return
        inner = Imdb(mode=mode, maxlen=maxlen,
                     synthetic_size=synthetic_size)
        self.word_idx = inner.word_idx
        self.docs, self.labels = inner.docs, inner.labels

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)
