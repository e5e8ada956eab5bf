"""STAR metric suite: the port's own copy of
``shgvqa_tpu/evalsuite/star.py``.

Exact-match accuracy over the 4-way answer-choice index
(``star_data.py:294-305``) plus the per-question-type breakdown the driver
computes by question-id prefix (``star.py:706-722``).

The reference's ``dump_result`` opens the file in ``'wb'`` then calls
``json.dump`` with str output — a TypeError on use (``star_data.py:325-332``).
The GQA-style payload is kept and written as text (a documented fix).
"""

from __future__ import annotations

import json
from typing import Dict, Mapping

STAR_QTYPES = ("Interaction", "Sequence", "Prediction", "Feasibility")


class STAREvaluator:
    def __init__(self, id2datum: Mapping[str, dict]):
        self.id2datum = id2datum

    def evaluate(self, quesid2ans: Mapping[str, int]) -> float:
        if not quesid2ans:
            return 0.0
        score = 0
        for quesid, ans in quesid2ans.items():
            if int(ans) == int(self.id2datum[quesid]["answer_choice"]):
                score += 1
        return score / len(quesid2ans)

    @staticmethod
    def sort_by_qtype(quesid2ans: Mapping[str, int]
                      ) -> Dict[str, Dict[str, int]]:
        by_type: Dict[str, Dict[str, int]] = {q: {} for q in STAR_QTYPES}
        for qid, ans in quesid2ans.items():
            for qtype in STAR_QTYPES:
                if qid.startswith(qtype):
                    by_type[qtype][qid] = ans
                    break
        return by_type

    def evaluate_by_qtype(self, quesid2ans: Mapping[str, int]
                          ) -> Dict[str, float]:
        return {
            qtype: self.evaluate(sub)
            for qtype, sub in self.sort_by_qtype(quesid2ans).items()
        }

    def dump_result(self, quesid2ans: Mapping[str, int], path: str) -> None:
        result = [
            {"questionId": qid, "prediction": int(ans)}
            for qid, ans in quesid2ans.items()
        ]
        with open(path, "w") as f:
            json.dump(result, f, indent=4, sort_keys=True)

    def oracle_score(self, quesids) -> float:
        quesid2ans = {
            qid: int(self.id2datum[qid]["answer_choice"]) for qid in quesids
        }
        return self.evaluate(quesid2ans)
