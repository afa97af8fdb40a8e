"""License-plate OCR text-match metrics (the port's copy of
vcm_ts_tpu/eval/text_metrics.py): full match, symbol-wise accuracy
(equal/non-equal length), Ratcliff-Obershelp ratio (difflib), Jaro-Winkler
similarity and 1-CER, dependency-free.
"""

from __future__ import annotations

from difflib import SequenceMatcher


def calculate_accuracy_symbolically(text1: str, text2: str) -> float:
    """(benchmark_plot.py:246-256)"""
    if len(text1) == 0 and len(text2) == 1:
        return 1.0
    if len(text1) == 0:
        return 0.0
    num_matches = sum(a == b for a, b in zip(text1, text2))
    return num_matches / len(text1)


def jaro_similarity(s1: str, s2: str) -> float:
    if s1 == s2:
        return 1.0
    if not s1 or not s2:
        return 0.0
    match_dist = max(len(s1), len(s2)) // 2 - 1
    s1_matches = [False] * len(s1)
    s2_matches = [False] * len(s2)
    matches = 0
    for i, c1 in enumerate(s1):
        start = max(0, i - match_dist)
        end = min(i + match_dist + 1, len(s2))
        for j in range(start, end):
            if s2_matches[j] or s2[j] != c1:
                continue
            s1_matches[i] = s2_matches[j] = True
            matches += 1
            break
    if matches == 0:
        return 0.0
    transpositions = 0
    k = 0
    for i in range(len(s1)):
        if not s1_matches[i]:
            continue
        while not s2_matches[k]:
            k += 1
        if s1[i] != s2[k]:
            transpositions += 1
        k += 1
    transpositions //= 2
    return (matches / len(s1) + matches / len(s2)
            + (matches - transpositions) / matches) / 3.0


def jaro_winkler(s1: str, s2: str, p: float = 0.1) -> float:
    jaro = jaro_similarity(s1, s2)
    prefix = 0
    for a, b in zip(s1, s2):
        if a != b or prefix == 4:
            break
        prefix += 1
    return jaro + prefix * p * (1 - jaro)


def levenshtein(s1: str, s2: str) -> int:
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    previous = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        current = [i + 1]
        for j, c2 in enumerate(s2):
            current.append(min(previous[j + 1] + 1, current[j] + 1,
                               previous[j] + (c1 != c2)))
        previous = current
    return previous[-1]


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate = edit distance / reference length."""
    if len(reference) == 0:
        return 0.0 if len(hypothesis) == 0 else 1.0
    return levenshtein(reference, hypothesis) / len(reference)


def calculate_ocr_metrics(dataset_annotations, annotations) -> dict:
    """(benchmark_plot.py:259-297) — percentages over the annotation list."""
    assert len(dataset_annotations) == len(annotations), \
        "Annotations size for calculate ocr metrics should be the same"
    full = symbol_equal = symbol_nonequal = ro = jw = cer_acc = 0.0
    for ref, hyp in zip(dataset_annotations, annotations):
        if ref == hyp:
            full += 1
        if len(ref) == len(hyp):
            symbol_equal += calculate_accuracy_symbolically(ref, hyp)
        symbol_nonequal += calculate_accuracy_symbolically(ref, hyp)
        ro += SequenceMatcher(None, ref, hyp).ratio()
        jw += jaro_winkler(ref, hyp)
        cer_acc += 1 - cer(ref, hyp)
    n = len(dataset_annotations)
    return {
        "full": full / n * 100,
        "symbol_equal_len": symbol_equal / n * 100,
        "symbol_nonequal_len": symbol_nonequal / n * 100,
        "RO": ro / n * 100,
        "JW": jw / n * 100,
        "cer": cer_acc / n * 100,
    }
