"""Label-vocabulary construction helpers: the port's own copy of
``shgvqa_tpu/data/vocab.py`` (plain Python; the same names, defaults and
file formats).

Rebuilds of the reference's vocab utilities
(``visualization_tools/vis_utils.py:239-358``): building the
relationship-triplet and action dictionaries from STAR-style annotations, and
loading the class-description files.  These produce the artifacts the
datasets consume (``rel_triplets_rp2idx`` / ``actions_rp2idx`` with labels
starting at 1; 0 is reserved for background/padding).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Tuple


def get_act_cls(annotation_dir: str,
                filename: str = "action_classes.txt") -> Dict[str, str]:
    """action_classes.txt lines like 'c001 someone is cooking' ->
    {tag: description} (vis_utils.get_act_cls)."""
    out: Dict[str, str] = {}
    with open(os.path.join(annotation_dir, filename)) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(" ", 1)
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def _name_column(annotation_dir: str, filename: str) -> List[str]:
    """Class files are 'tag name' lines ('o000 person'); the reference keeps
    only the name column (vis_utils.get_vocab:191-213 split(' ')[1])."""
    out: List[str] = []
    with open(os.path.join(annotation_dir, filename)) as f:
        for line in f:
            line = line.strip("\n")
            if line.strip():
                parts = line.split(" ")
                out.append(parts[1] if len(parts) > 1 else parts[0])
    return out


def get_vocab(annotation_dir: str) -> Tuple[List[str], List[str], List[str]]:
    """(object, relationship, verb) name lists from *_classes.txt.

    The reference's get_vocab (vis_utils.py:191-214) mistakenly appends the
    verb names into rel_vocab and returns a 3-tuple that its only caller
    unpacks as 2 (star_data.py:149 -> latent ValueError).  We keep the
    intended semantics: three separate name lists; verbs empty when the file
    is absent (STAR's data/ dir has one, AGQA annotations do too).
    """
    objs = _name_column(annotation_dir, "object_classes.txt")
    rels = _name_column(annotation_dir, "relationship_classes.txt")
    verb_path = os.path.join(annotation_dir, "verb_classes.txt")
    verbs = (_name_column(annotation_dir, "verb_classes.txt")
             if os.path.isfile(verb_path) else [])
    return objs, rels, verbs


def get_vocab_dict(annotation_dir: str) -> Tuple[Dict[str, str], ...]:
    """Tag->name dicts for objects/relationships/verbs
    (vis_utils.get_vocab_dict:226-254)."""
    out = []
    for name in ("object_classes.txt", "relationship_classes.txt",
                 "verb_classes.txt"):
        vocab: Dict[str, str] = {}
        path = os.path.join(annotation_dir, name)
        if os.path.isfile(path):
            with open(path) as f:
                for line in f:
                    line = line.strip("\n")
                    if line.strip():
                        parts = line.split(" ")
                        vocab[parts[0]] = parts[1] if len(parts) > 1 else ""
        out.append(vocab)
    return tuple(out)


def create_relationship_data(datums: Iterable[dict]) -> Dict[str, dict]:
    """Scan STAR datums' situations for unique (person, relation, object)
    triplets -> bidirectional dicts with indices starting at 1
    (vis_utils.create_relationship_data:272-342)."""
    triplets: List[tuple] = []
    seen = set()
    for datum in datums:
        for situation in datum.get("situations", {}).values():
            pairs = situation.get("rel_pairs", [])
            labels = situation.get("rel_labels", [])
            for rp, rl in zip(pairs, labels):
                t = (rp[0], rl, rp[1])
                if t not in seen:
                    seen.add(t)
                    triplets.append(t)
    rp2idx = {t: i + 1 for i, t in enumerate(triplets)}  # 0 = background
    idx2rp = {i + 1: t for i, t in enumerate(triplets)}
    return {"rel_triplets": triplets,
            "rel_triplets_rp2idx": rp2idx,
            "rel_triplets_idx2rp": idx2rp}


def get_action_dictionaries(action_classes: Dict[str, str]) -> Dict[str, dict]:
    """Action tag <-> index dicts, indices from 1
    (vis_utils.get_action_dictionaries:348-358)."""
    tags = list(action_classes.keys())
    rp2idx = {t: i + 1 for i, t in enumerate(tags)}
    idx2rp = {i + 1: t for i, t in enumerate(tags)}
    return {"actions": tags,
            "actions_rp2idx": rp2idx,
            "actions_idx2rp": idx2rp}
