"""Caption metrics: BLEU, CIDEr, ROUGE-L and METEOR (host-side Python).

A copy of the scorers of ``d3net_tpu/eval/capeval.py`` (the port never
imports the JAX package); the same candidates give the same numbers.

Parity targets: the COCO-caption ports vendored by the reference in
``lib/capeval/``:
- BLEU-4 with closest-reference-length brevity penalty and epsilon-smoothed
  per-sentence scores (``lib/capeval/bleu``),
- CIDEr with corpus document frequencies from the GT side, TF-IDF cosine
  over n-grams 1..4, length gaussian penalty (sigma 6), x10 scale
  (``lib/capeval/cider``),
- ROUGE-L F-measure with beta=1.2 (``lib/capeval/rouge``),
- METEOR through the official meteor-1.5.jar where java and the jar exist
  (:class:`MeteorJar`, the reference wrapper's stdio protocol), else in
  pure Python (exact and Porter-stem matches). The caption evaluator
  scores it only where nltk is importable, as the JAX package's does:
  without nltk ``meteor_available()`` is False and it reports 0.0.

All operate on {key: [sentence strings]} dicts like the originals.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# --------------------------------------------------------------------------
# BLEU
# --------------------------------------------------------------------------

def bleu(gts: Dict, cands: Dict, n: int = 4) -> Tuple[List[float], List[List[float]]]:
    """Corpus BLEU-1..n + per-sentence scores (COCO 'closest' length, small-
    constant smoothing on the per-sentence path like the reference port)."""
    small = 1e-9
    tiny = 1e-15
    keys = list(cands.keys())
    totals = [0.0] * n  # corpus clipped counts
    guesses = [0.0] * n
    c_len, r_len = 0, 0
    sent_scores: List[List[float]] = [[] for _ in range(n)]

    for k in keys:
        cand = cands[k][0].split()
        refs = [r.split() for r in gts[k]]
        c = len(cand)
        r = min((abs(len(ref) - c), len(ref)) for ref in refs)[1]
        c_len += c
        r_len += r

        comps_correct, comps_guess = [], []
        for i in range(1, n + 1):
            cnt = _ngrams(cand, i)
            max_ref = Counter()
            for ref in refs:
                rc = _ngrams(ref, i)
                for g, v in rc.items():
                    max_ref[g] = max(max_ref[g], v)
            clipped = sum(min(v, max_ref[g]) for g, v in cnt.items())
            guess = max(len(cand) - i + 1, 0)
            comps_correct.append(clipped)
            comps_guess.append(guess)
            totals[i - 1] += clipped
            guesses[i - 1] += guess

        # per-sentence score with smoothing
        bp = 1.0 if c > r else math.exp(1 - r / c) if c > 0 else 0.0
        score = 1.0
        for i in range(n):
            score *= (comps_correct[i] + tiny) / (comps_guess[i] + small)
            sent_scores[i].append(score ** (1.0 / (i + 1)) * bp)

    bp = 1.0 if c_len > r_len else math.exp(1 - r_len / max(c_len, 1))
    corpus = []
    score = 1.0
    for i in range(n):
        score *= (totals[i] + tiny) / (guesses[i] + small)
        corpus.append(score ** (1.0 / (i + 1)) * bp)
    return corpus, sent_scores


# --------------------------------------------------------------------------
# CIDEr
# --------------------------------------------------------------------------

class Cider:
    """CIDEr-D-less classic CIDEr (matches the reference's vendored port)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict, cands: Dict) -> Tuple[float, List[float]]:
        keys = list(cands.keys())
        # document frequencies over GT reference sets
        df = defaultdict(float)
        for k in keys:
            seen = set()
            for ref in gts[k]:
                for i in range(1, self.n + 1):
                    seen |= set(_ngrams(ref.split(), i).keys())
            for g in seen:
                df[g] += 1.0
        log_m = math.log(max(len(keys), 1))

        def tfidf_vec(tokens):
            vecs = []
            length = len(tokens)
            for i in range(1, self.n + 1):
                cnt = _ngrams(tokens, i)
                vec = {}
                norm = 0.0
                for g, v in cnt.items():
                    idf = log_m - math.log(max(df[g], 1.0))
                    w = v * idf
                    vec[g] = w
                    norm += w * w
                vecs.append((vec, math.sqrt(norm)))
            return vecs, length

        scores = []
        for k in keys:
            cand_tokens = cands[k][0].split()
            cv, cl = tfidf_vec(cand_tokens)
            sc = 0.0
            for ref in gts[k]:
                rv, rl = tfidf_vec(ref.split())
                delta = cl - rl
                sim_total = 0.0
                for i in range(self.n):
                    (c_vec, c_norm), (r_vec, r_norm) = cv[i], rv[i]
                    num = sum(min(c_vec[g], r_vec.get(g, 0.0)) * r_vec.get(g, 0.0)
                              for g in c_vec)
                    if c_norm > 0 and r_norm > 0:
                        sim = num / (c_norm * r_norm)
                    else:
                        sim = 0.0
                    sim *= math.exp(-(delta**2) / (2 * self.sigma**2))
                    sim_total += sim
                sc += sim_total / self.n
            scores.append(10.0 * sc / max(len(gts[k]), 1))
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores


# --------------------------------------------------------------------------
# ROUGE-L
# --------------------------------------------------------------------------

def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


def rouge_l(gts: Dict, cands: Dict, beta: float = 1.2) -> Tuple[float, List[float]]:
    scores = []
    for k in cands.keys():
        cand = cands[k][0].split()
        best = 0.0
        for ref in gts[k]:
            r = ref.split()
            lcs = _lcs_len(cand, r)
            prec = lcs / len(cand) if cand else 0.0
            rec = lcs / len(r) if r else 0.0
            if prec and rec:
                f = ((1 + beta**2) * prec * rec) / (rec + beta**2 * prec)
            else:
                f = 0.0
            best = max(best, f)
        scores.append(best)
    mean = sum(scores) / max(len(scores), 1)
    return mean, scores


# --------------------------------------------------------------------------
# METEOR
# --------------------------------------------------------------------------
#
# A clean-room pure-Python METEOR with the classic parameters (Banerjee &
# Lavie 2005 / Lavie & Agarwal 2007: alpha=0.9, beta=3.0, gamma=0.5) and two
# match stages — exact and Porter-stem.  WordNet-synonym and paraphrase-table
# stages need corpus data that is unavailable offline; scores therefore
# lower-bound the jar's output slightly.  Protocol matches the reference
# wrapper: per-segment score = max over references; corpus score = mean over
# segments.


def meteor_available() -> bool:
    """True when the Porter stemmer dependency (nltk) is importable."""
    try:
        import nltk  # noqa: F401
    except ImportError:
        return False
    return True


def _porter_stem(word: str) -> str:
    from nltk.stem import PorterStemmer

    global _STEMMER
    try:
        return _STEMMER.stem(word)
    except NameError:
        _STEMMER = PorterStemmer()
        return _STEMMER.stem(word)


def _meteor_align(cand: List[str], ref: List[str]) -> List[Tuple[int, int]]:
    """Stage-wise greedy alignment: exact matches first, then Porter-stem
    matches over leftovers.  Within a stage each candidate word takes the
    first unmatched reference occurrence (the classic METEOR heuristic)."""
    matches: List[Tuple[int, int]] = []
    used_c, used_r = set(), set()
    for stage in (lambda w: w, _porter_stem):
        r_slots = defaultdict(list)
        for j, w in enumerate(ref):
            if j not in used_r:
                r_slots[stage(w)].append(j)
        for i, w in enumerate(cand):
            if i in used_c:
                continue
            key = stage(w)
            while r_slots.get(key):
                j = r_slots[key].pop(0)
                if j in used_r:
                    continue
                matches.append((i, j))
                used_c.add(i)
                used_r.add(j)
                break
    return sorted(matches)


def _meteor_segment(cand: List[str], ref: List[str], alpha: float,
                    beta: float, gamma: float) -> float:
    matches = _meteor_align(cand, ref)
    m = len(matches)
    if m == 0 or not cand or not ref:
        return 0.0
    prec = m / len(cand)
    rec = m / len(ref)
    fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
    # chunks: maximal runs adjacent in both candidate and reference
    chunks = 1
    for (c0, r0), (c1, r1) in zip(matches, matches[1:]):
        if c1 != c0 + 1 or r1 != r0 + 1:
            chunks += 1
    penalty = gamma * (chunks / m) ** beta
    return fmean * (1.0 - penalty)


def meteor(gts: Dict, cands: Dict, alpha: float = 0.9, beta: float = 3.0,
           gamma: float = 0.5) -> Tuple[float, List[float]]:
    """Corpus METEOR: the official jar when :meth:`MeteorJar.maybe` finds
    one (its scores compare with the reference's), else the Python scorer
    (needs nltk), whose scores compare only with themselves."""
    jar = MeteorJar.maybe()
    if jar is not None:
        try:
            return jar.compute_score(gts, cands)
        finally:
            jar.close()
    scores = []
    for k in cands.keys():
        cand = cands[k][0].split()
        best = max(
            (_meteor_segment(cand, ref.split(), alpha, beta, gamma)
             for ref in gts[k]),
            default=0.0,
        )
        scores.append(best)
    mean = sum(scores) / max(len(scores), 1)
    return mean, scores


class MeteorJar:
    """meteor-1.5.jar stdio wrapper, protocol-exact with the reference's
    ``lib/capeval/meteor/meteor.py:12-44``:

      command:  java -jar -Xmx2G <jar> - - -stdio -l en -norm
      per segment:  "SCORE ||| ref1 ||| ref2 ... ||| candidate" -> stats
      batch:        "EVAL ||| stats1 ||| stats2 ..." -> per-segment scores,
                    then the aggregate corpus score.

    Activated when java is on PATH and a jar is found via D3NET_METEOR_JAR
    or next to this file.  D3NET_METEOR_CMD overrides the full command (the
    protocol test drives a mock scorer through it). The JAX package's
    wrapper, line for line; ``close`` also reaps the process.
    """

    def __init__(self, cmd: List[str], cwd: Optional[str] = None):
        self.proc = subprocess.Popen(
            cmd, cwd=cwd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )

    @staticmethod
    def maybe() -> Optional["MeteorJar"]:
        cmd_override = os.environ.get("D3NET_METEOR_CMD")
        if cmd_override:
            return MeteorJar(cmd_override.split())
        jar = os.environ.get("D3NET_METEOR_JAR") or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "meteor-1.5.jar"
        )
        if not (os.path.exists(jar) and shutil.which("java")):
            return None
        return MeteorJar(
            ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en",
             "-norm"],
            cwd=os.path.dirname(jar),
        )

    def compute_score(self, gts: Dict, cands: Dict) -> Tuple[float, List[float]]:
        keys = list(cands.keys())
        eval_line = "EVAL"
        for k in keys:
            refs = [r.replace("|||", "").replace("\n", " ") for r in gts[k]]
            cand = cands[k][0].replace("|||", "").replace("\n", " ")
            score_line = " ||| ".join(("SCORE", " ||| ".join(refs), cand))
            self.proc.stdin.write((score_line + "\n").encode())
            self.proc.stdin.flush()
            eval_line += " ||| " + self.proc.stdout.readline().decode().strip()
        self.proc.stdin.write((eval_line + "\n").encode())
        self.proc.stdin.flush()
        scores = [float(self.proc.stdout.readline().strip())
                  for _ in keys]
        mean = float(self.proc.stdout.readline().strip())
        return mean, scores

    def close(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:     # the scorer has already gone
            pass
        self.proc.kill()
        self.proc.wait()
