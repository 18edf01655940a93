"""Context-DEPENDENT synthetic corpus: topic-conditioned word choice.

The original generator (:mod:`jlm.data.synthetic`) picks each slot's
word independently, so a *unigram* model reaches the exact Bayes ceiling
and the reference's core quality claim — "LSTM LM beats the n-gram
baseline on conversion accuracy" (SURVEY.md §8 quality row; ref:
JLM:README.md / arXiv:1810.09309) — is untestable by construction
(VERDICT r2 missing #1).

This generator adds a latent per-sentence TOPIC: every content word is
drawn with topic-conditioned weights, so homophones resolve differently
per topic (雨/飴 for あめ, 橋/箸 for はし, 紙/神/髪 for かみ, …) and the
evidence for the topic is spread over the WHOLE sentence — usually across
topic-neutral particles, which blinds a bigram:

- a unigram decoder must always pick each reading's globally most likely
  display — its accuracy is capped well below the ceiling;
- a bigram sees only the adjacent word (for nouns that is a particle
  carrying no topic signal), recovering only part of the gap;
- a model that integrates the full left context (the LSTM) can infer the
  topic and approach the exact Bayes ceiling, and beam search beats
  greedy because early homophone commitments pay off only later.

Everything is a pure function of the seed, and the true per-slot
probabilities are exported (:func:`pool_reading_probs`) so the exact
Bayes ceiling remains computable by DP with a topic marginalization
(:func:`jlm.eval.ceiling.bayes_ceiling_ctx`).
"""

from __future__ import annotations

import bisect
import random
from typing import Dict, List, Sequence, Tuple

from jlm.data.synthetic import (
    _ADJS,
    _ADVS,
    _NOUNS,
    _PARTS,
    _TEMPLATES,
    _VERBS,
)

TOPICS: Tuple[str, ...] = ("nature", "food", "city", "school")

# display -> {topic: weight multiplier}.  Missing entries default to 1.0
# (topic-neutral).  Homophone groups get CONTRASTING affinities so the
# conversion decision requires the topic; indicator words (mostly
# non-homophones) reveal it.  The particle pool is left fully neutral on
# purpose: in the noun-particle-noun templates a bigram model then sees no
# topic evidence for noun homophones.
# Strength of the topic conditioning.  Calibrated so the exact ceiling sits
# well above what any context-free or adjacent-word model can reach
# (measured: ceiling 0.77, unigram Viterbi 0.43, bigram Viterbi 0.54 on the
# 200-sentence test set) — a ~23-point window for context models to win.
_BOOST = 30.0
_AFFINITY: Dict[str, Dict[str, float]] = {
    # --- homophone discrimination ---
    "雨": {"nature": _BOOST}, "飴": {"food": _BOOST},
    "橋": {"city": _BOOST}, "箸": {"food": _BOOST}, "端": {},
    "神": {"nature": _BOOST}, "紙": {"school": _BOOST}, "髪": {},
    "花": {"nature": _BOOST}, "鼻": {},
    "海": {"nature": _BOOST}, "膿": {},
    "木": {"nature": _BOOST}, "気": {},
    "目": {}, "芽": {"nature": _BOOST},
    "川": {"nature": _BOOST}, "皮": {"food": _BOOST},
    "街": {"city": _BOOST}, "町": {"city": _BOOST},
    "道": {"city": _BOOST}, "未知": {"school": _BOOST},
    "石": {"nature": _BOOST}, "意思": {"school": _BOOST},
    "公園": {"nature": _BOOST, "city": 4.0}, "講演": {"school": _BOOST},
    "今日": {}, "京": {"city": _BOOST}, "経": {"school": _BOOST},
    "朝": {}, "麻": {"nature": _BOOST},
    "火": {"food": _BOOST}, "日": {"nature": _BOOST},
    "空き": {"city": _BOOST}, "秋": {"nature": _BOOST},
    "松": {"nature": _BOOST}, "下": {},
    "今": {}, "居間": {"food": _BOOST},
    # --- verb homophones ---
    "書く": {"school": _BOOST}, "描く": {"school": 4.0, "nature": 4.0},
    "聞く": {}, "効く": {"food": _BOOST},
    "買う": {"city": _BOOST}, "飼う": {"nature": _BOOST},
    "降る": {"nature": _BOOST}, "振る": {},
    "話す": {}, "放す": {"nature": _BOOST},
    "帰る": {}, "蛙": {"nature": _BOOST}, "変える": {},
    "待つ": {"city": _BOOST},
    "会う": {}, "合う": {},
    "なる": {}, "鳴る": {"nature": _BOOST},
    "した": {}, "飲む": {"food": _BOOST}, "食べる": {"food": _BOOST},
    "読む": {"school": _BOOST},
    # --- adjective homophones ---
    "暑い": {"nature": _BOOST}, "熱い": {"food": _BOOST},
    "厚い": {"school": _BOOST},
    "早い": {"school": 4.0}, "速い": {"city": _BOOST},
    "良い": {}, "いい": {},
    # --- pure topic indicators (non-homophones) ---
    "天気": {"nature": _BOOST}, "空": {"nature": _BOOST},
    "山": {"nature": _BOOST}, "冬": {"nature": _BOOST},
    "夏": {"nature": _BOOST}, "春": {"nature": _BOOST},
    "鳥": {"nature": _BOOST}, "犬": {"nature": 4.0},
    "飯": {"food": _BOOST}, "水": {"food": 4.0, "nature": 4.0},
    "電車": {"city": _BOOST}, "会社": {"city": _BOOST},
    "仕事": {"city": _BOOST}, "車": {"city": _BOOST},
    "東京": {"city": _BOOST}, "電気": {"city": _BOOST},
    "学校": {"school": _BOOST}, "先生": {"school": _BOOST},
    "学生": {"school": _BOOST}, "本": {"school": _BOOST},
    "言葉": {"school": _BOOST}, "映画": {"school": 4.0},
    "音楽": {"school": 4.0}, "医者": {"city": 4.0},
}

_INV = 1.0 / 2.2  # same zipf base mass as jlm.data.synthetic


def _base_mass(k: int, n: int) -> float:
    return ((k + 1) / n) ** _INV - (k / n) ** _INV


def pool_probs(pool: Sequence[Tuple[str, str, str]], topic: str) -> List[float]:
    """Exact P(word index | pool, topic) used by generator AND ceiling."""
    n = len(pool)
    w = [
        _base_mass(k, n) * _AFFINITY.get(d, {}).get(topic, 1.0)
        for k, (d, _r, _p) in enumerate(pool)
    ]
    z = sum(w)
    return [x / z for x in w]


def pool_reading_probs(
    pool: Sequence[Tuple[str, str, str]], topic: str
) -> Dict[str, List[Tuple[str, float]]]:
    """reading -> [(display, P(word|pool,topic))] for the ceiling DP."""
    probs = pool_probs(pool, topic)
    out: Dict[str, List[Tuple[str, float]]] = {}
    for (display, reading, _pos), p in zip(pool, probs):
        out.setdefault(reading, []).append((display, p))
    return out


# Precomputed cumulative distributions per (pool id, topic).
_CDFS: Dict[Tuple[int, str], List[float]] = {}
_POOLS = {id(p): p for p in (_NOUNS, _VERBS, _ADJS, _PARTS, _ADVS)}


def _sample(rng: random.Random, pool, topic: str):
    key = (id(pool), topic)
    cdf = _CDFS.get(key)
    if cdf is None:
        probs = pool_probs(pool, topic)
        cdf, acc = [], 0.0
        for p in probs:
            acc += p
            cdf.append(acc)
        _CDFS[key] = cdf
    idx = bisect.bisect_left(cdf, rng.random())
    return pool[min(idx, len(pool) - 1)]


def _gen_tokens(rng: random.Random):
    topic = TOPICS[rng.randrange(len(TOPICS))]
    tpl = rng.choice(_TEMPLATES)
    return topic, [_sample(rng, pool, topic) for pool in tpl]


def generate_corpus_ctx(n_sentences: int = 30_000, seed: int = 1234) -> List[str]:
    """Corpus lines of ``display/reading/POS`` tokens, topic-conditioned."""
    rng = random.Random(seed)
    lines = []
    for _ in range(n_sentences):
        _topic, toks = _gen_tokens(rng)
        lines.append(" ".join(f"{d}/{r}/{p}" for d, r, p in toks))
    return lines


def generate_test_set_ctx(
    n_sentences: int = 400, seed: int = 777
) -> List[Tuple[str, str]]:
    """Fixed eval set: (kana reading string, gold display string)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n_sentences):
        _topic, toks = _gen_tokens(rng)
        out.append(
            ("".join(r for _, r, _ in toks), "".join(d for d, _, _ in toks))
        )
    return out


def generate_test_tokens_ctx(
    n_sentences: int = 400, seed: int = 777
) -> List[Tuple[str, List[Tuple[str, str, str]]]]:
    """Same sentences as :func:`generate_test_set_ctx`, with gold tokens.

    Returns (kana, [(display, reading, pos), ...]) — used for the rare-word
    accuracy split in the D-softmax prefix-vs-disjoint A/B.
    """
    rng = random.Random(seed)
    out = []
    for _ in range(n_sentences):
        _topic, toks = _gen_tokens(rng)
        out.append(("".join(r for _, r, _ in toks), list(toks)))
    return out
