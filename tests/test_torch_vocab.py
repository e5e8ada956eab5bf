"""The port's label-vocabulary helpers (``data/vocab.py``) against the JAX
package's on a synthetic STAR-style annotation directory: every helper's
result equal, with and without the optional verb file."""

import numpy as np
import pytest

from shgvqa_tpu.data import vocab as jax_vocab
from shgvqa_tpu_torch.data import synthetic, vocab


def _annotations(root, verbs):
    rng = np.random.RandomState(0)
    (root / "action_classes.txt").write_text("".join(
        f"c{i:03d} someone is doing thing {i}\n" for i in range(12))
        + "\nc999\n")
    (root / "object_classes.txt").write_text("".join(
        f"o{i:03d} object{i}\n" for i in range(9)))
    (root / "relationship_classes.txt").write_text("".join(
        f"r{i:03d} rel_{rng.randint(100)}\n" for i in range(7)) + "r999\n")
    if verbs:
        (root / "verb_classes.txt").write_text("".join(
            f"v{i:03d} verb{i}\n" for i in range(5)))
    return str(root)


@pytest.mark.parametrize("verbs", [True, False], ids=["verbs", "no_verbs"])
def test_vocab_helpers_match_jax(tmp_path, verbs):
    root = _annotations(tmp_path, verbs)
    acts = vocab.get_act_cls(root)
    assert acts == jax_vocab.get_act_cls(root) and acts["c999"] == ""
    assert vocab.get_vocab(root) == jax_vocab.get_vocab(root)
    assert vocab.get_vocab_dict(root) == jax_vocab.get_vocab_dict(root)
    assert (vocab.get_action_dictionaries(acts)
            == jax_vocab.get_action_dictionaries(acts))
    assert vocab.get_action_dictionaries(acts)["actions_rp2idx"]["c000"] == 1
    if not verbs:
        assert vocab.get_vocab(root)[2] == []


def test_relationship_data_matches_jax():
    datums, _ = synthetic.make_star_data(n=24, seed=3)
    for datum in datums:                       # STAR's annotation schema
        for situ in datum["situations"].values():
            k = len(situ["rel_labels"])
            situ["rel_pairs"] = [[f"o{i:03d}", f"o{i + 1:03d}"]
                                 for i in range(k)]
            situ["rel_labels"] = [f"r{int(x) % 7:03d}"
                                  for x in situ["rel_labels"]]
    got = vocab.create_relationship_data(datums)
    assert got == jax_vocab.create_relationship_data(datums)
    assert min(got["rel_triplets_idx2rp"]) == 1
    assert got == vocab.create_relationship_data(datums + [{}])
