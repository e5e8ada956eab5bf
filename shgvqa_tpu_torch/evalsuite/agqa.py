"""AGQA 2.0 metric suite: the port's own copy of
``shgvqa_tpu/evalsuite/agqa.py``.

The metric vectors of the reference evaluator: the 31-way all-qtypes
report, novelComp (15), compSteps (3), indirectRef recall (9) and paired
precision (9), built from one accumulator pass per suite.  Vector orderings
are part of the public contract (the driver prints them positionally).

Answers arrive as indices and are compared as strings through
``list(answer_vocab.keys())``; reasoning tags count once per occurrence;
an indirect question counts towards precision only if its direct twin was
answered correctly.  A category with no question scores 0.0.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Mapping, Tuple


def _ratio(hits: float, total: int) -> float:
    return hits / total if total else 0.0


class _Acc:
    __slots__ = ("hits", "total")

    def __init__(self) -> None:
        self.hits = 0.0
        self.total = 0

    def add(self, correct: bool, times: int = 1) -> None:
        self.total += times
        if correct:
            self.hits += times

    @property
    def value(self) -> float:
        return _ratio(self.hits, self.total)


def _with_anstype_splits(name: str) -> List[str]:
    return [name, name + "/binary", name + "/open"]


# --- evaluateAllQtypes (agqa_data.py:364-697): 31-element vector order ---
AGQA_ALL_QTYPES_NAMES: List[str] = (
    _with_anstype_splits("overall")
    + _with_anstype_splits("reasoning/obj-rel")
    + ["reasoning/rel-act", "reasoning/obj-act"]
    + _with_anstype_splits("reasoning/superlative")
    + _with_anstype_splits("reasoning/sequencing")
    + ["reasoning/exists"]
    + _with_anstype_splits("reasoning/duration-comparison")
    + ["reasoning/action-recognition"]
    + _with_anstype_splits("semantic/object")
    + ["semantic/relation"]
    + _with_anstype_splits("semantic/action")
    + [
        "structural/query",
        "structural/compare",
        "structural/choose",
        "structural/logic",
        "structural/verify",
    ]
)

# reasoning tags that get binary/open sub-splits in the reference
_REASONING_SPLIT = {"obj-rel", "superlative", "sequencing", "duration-comparison"}
_REASONING_PLAIN = {"rel-act", "obj-act", "exists", "action-recognition"}
_SEMANTIC_SPLIT = {"object", "action"}
_SEMANTIC_PLAIN = {"relation"}
_STRUCTURAL = ["query", "compare", "choose", "logic", "verify"]

# --- evaluateNovelComp (agqa_data.py:737-880): 15-element vector order ---
AGQA_NOVEL_COMP_NAMES: List[str] = (
    _with_anstype_splits("overall")
    + _with_anstype_splits("nc_seq")
    + _with_anstype_splits("nc_sup")
    + _with_anstype_splits("nc_dur")
    + _with_anstype_splits("nc_objrel")
)

# --- evaluateIndirectRef / evaluatePrecision: 9-element vector order ---
AGQA_INDIRECT_NAMES: List[str] = (
    _with_anstype_splits("i_obj")
    + _with_anstype_splits("i_act")
    + _with_anstype_splits("i_temp")
)


class AGQAEvaluator:
    """Metric suite over an id->datum mapping and an answer vocabulary.

    ``id2datum`` maps question_id -> datum dict with the AGQA annotation
    fields (answer, ans_type, global, semantic, structural, nc_*, i_*,
    direct_equiv, indirect, steps, more_steps).
    ``answer_vocab`` maps answer string -> index; index order must match
    insertion order (the reference uses ``list(vocab.keys())``).
    """

    def __init__(self, id2datum: Mapping[str, dict],
                 answer_vocab: Mapping[str, int]):
        self.id2datum = id2datum
        self.answer_vocab = answer_vocab
        self.index_to_ans = list(answer_vocab.keys())

    # -- helpers ---------------------------------------------------------
    def _ans_str(self, ans: int) -> str:
        return self.index_to_ans[ans]

    @staticmethod
    def _splits(datum: dict) -> Tuple[bool, bool]:
        return datum.get("ans_type") == "binary", datum.get("ans_type") == "open"

    def _add_split(self, accs: Dict[str, _Acc], base: str, datum: dict,
                   correct: bool, times: int = 1) -> None:
        is_bin, is_open = self._splits(datum)
        accs[base].add(correct, times)
        if is_bin:
            accs[base + "/binary"].add(correct, times)
        if is_open:
            accs[base + "/open"].add(correct, times)

    # -- evaluateOverall (agqa_data.py:350-359) --------------------------
    def evaluate_overall(self, quesid2ans: Mapping[str, int]) -> float:
        score = 0
        for quesid, ans in quesid2ans.items():
            datum = self.id2datum[quesid]
            if int(ans) == int(self.answer_vocab[datum["answer"]]):
                score += 1
        return _ratio(score, len(quesid2ans))

    # -- evaluateAllQtypes (agqa_data.py:364-697) -------------------------
    def evaluate_all_qtypes(self, quesid2ans: Mapping[str, int]) -> List[float]:
        accs: Dict[str, _Acc] = {n: _Acc() for n in AGQA_ALL_QTYPES_NAMES}
        for quesid, ans in quesid2ans.items():
            datum = self.id2datum[quesid]
            correct = self._ans_str(ans) == datum["answer"]
            self._add_split(accs, "overall", datum, correct)

            sem = datum.get("semantic")
            if sem in _SEMANTIC_SPLIT:
                self._add_split(accs, f"semantic/{sem}", datum, correct)
            elif sem in _SEMANTIC_PLAIN:
                accs[f"semantic/{sem}"].add(correct)

            struct = datum.get("structural")
            if struct in _STRUCTURAL:
                accs[f"structural/{struct}"].add(correct)

            for tag in datum.get("global", []):
                if tag in _REASONING_SPLIT:
                    self._add_split(accs, f"reasoning/{tag}", datum, correct)
                elif tag in _REASONING_PLAIN:
                    accs[f"reasoning/{tag}"].add(correct)
        return [accs[n].value for n in AGQA_ALL_QTYPES_NAMES]

    # -- evaluateCompSteps (agqa_data.py:702-732) -------------------------
    def evaluate_comp_steps(self, quesid2ans: Mapping[str, int]) -> List[float]:
        accs = {n: _Acc() for n in _with_anstype_splits("overall")}
        for quesid, ans in quesid2ans.items():
            datum = self.id2datum[quesid]
            correct = self._ans_str(ans) == datum["answer"]
            self._add_split(accs, "overall", datum, correct)
        return [accs[n].value for n in _with_anstype_splits("overall")]

    # -- evaluateNovelComp (agqa_data.py:737-880) --------------------------
    def evaluate_novel_comp(self, quesid2ans: Mapping[str, int]) -> List[float]:
        accs = {n: _Acc() for n in AGQA_NOVEL_COMP_NAMES}
        for quesid, ans in quesid2ans.items():
            datum = self.id2datum[quesid]
            correct = self._ans_str(ans) == datum["answer"]
            self._add_split(accs, "overall", datum, correct)
            for flag in ("nc_seq", "nc_sup", "nc_dur", "nc_objrel"):
                if datum.get(flag) == 1:
                    self._add_split(accs, flag, datum, correct)
        return [accs[n].value for n in AGQA_NOVEL_COMP_NAMES]

    # -- evaluateIndirectRef (agqa_data.py:978-1093) -----------------------
    def evaluate_indirect_ref(self, quesid2ans: Mapping[str, int]
                              ) -> Tuple[List[float], List[dict]]:
        accs = {n: _Acc() for n in AGQA_INDIRECT_NAMES}
        precision_qs: List[dict] = []
        for quesid, ans in quesid2ans.items():
            datum = self.id2datum[quesid]
            ans_str = self._ans_str(ans)
            correct = ans_str == datum["answer"]
            for flag in ("i_obj", "i_act", "i_temp"):
                if datum.get(flag) == 1:
                    self._add_split(accs, flag, datum, correct)
            # paired precision protocol: keep indirect questions whose direct
            # twin was answered correctly
            if datum.get("direct_equiv") is not None and datum.get("indirect") == 1:
                equiv_id = datum["direct_equiv"]
                if equiv_id in self.id2datum and equiv_id in quesid2ans:
                    equiv_datum = self.id2datum[equiv_id]
                    equiv_pred = self._ans_str(quesid2ans[equiv_id])
                    if equiv_pred == equiv_datum["answer"]:
                        entry = dict(datum)
                        entry["prediction"] = ans_str
                        precision_qs.append(entry)
        return [accs[n].value for n in AGQA_INDIRECT_NAMES], precision_qs

    # -- evaluatePrecision (agqa_data.py:886-973) ---------------------------
    def evaluate_precision(self, questions: Iterable[dict]) -> List[float]:
        accs = {n: _Acc() for n in AGQA_INDIRECT_NAMES}
        for q in questions:
            correct = q["prediction"] == q["answer"]
            for flag in ("i_obj", "i_act", "i_temp"):
                if q.get(flag) == 1:
                    is_bin = q.get("ans_type") == "binary"
                    is_open = q.get("ans_type") == "open"
                    accs[flag].add(correct)
                    if is_bin:
                        accs[flag + "/binary"].add(correct)
                    if is_open:
                        accs[flag + "/open"].add(correct)
        return [accs[n].value for n in AGQA_INDIRECT_NAMES]

    # -- dump_result (agqa_data.py:1110-1146) -------------------------------
    def dump_result(self, quesid2ans: Mapping[str, int], path: str,
                    indirect_ref: bool = False) -> None:
        result = []
        for ques_id, ans in quesid2ans.items():
            datum = self.id2datum[ques_id]
            prediction = self._ans_str(ans)
            if indirect_ref:
                result.append({
                    "id": datum["question_id"],
                    "question": datum["question"],
                    "ans_type": datum["ans_type"],
                    "question type": datum["global"],
                    "prediction": prediction,
                    "answer": datum["answer"],
                    "directEq": datum.get("direct_equiv"),
                    "i_obj": datum.get("i_obj"),
                    "i_act": datum.get("i_act"),
                    "i_temp": datum.get("i_temp"),
                    "indirectFlag": datum.get("indirect"),
                })
            else:
                result.append({
                    "id": datum["question_id"],
                    "question": datum["question"],
                    "ans_type": datum["ans_type"],
                    "question type": datum["global"],
                    "prediction": prediction,
                    "answer": datum["answer"],
                    "steps:": datum.get("steps"),
                    "more_steps": datum.get("more_steps"),
                })
        with open(path, "w") as f:
            json.dump(result, f, indent=4, sort_keys=True)

    # Oracle sanity check (agqaHGQA.py:841-856): feed ground truth through
    # the evaluator; anything below 1.0 flags vocab/metric plumbing breakage.
    def oracle_score(self, quesids: Iterable[str]) -> float:
        quesid2ans = {
            qid: int(self.answer_vocab[self.id2datum[qid]["answer"]])
            for qid in quesids
        }
        return self.evaluate_overall(quesid2ans)
