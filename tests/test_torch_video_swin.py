"""The port's Video Swin trunk (``models/video_swin.py``, registered as
``video_swin_impl``) against the JAX package's, f32, at the TOY dims of
``tests/test_video_swin.py`` (embed 8, depths (1, 2, 1), heads (1, 2, 4),
window (2, 2, 2)), with the checks of
``tests/test_torch_backbones_extra.py``.  Two clip shapes: 8 frames of 32
pixels (shifted windows and both merges) and 6 frames of 40 (window
padding, odd sides into a merge, a clamped window)."""

import numpy as np
import pytest
import torch

from shgvqa_tpu.models import video_swin as jax_swin
from shgvqa_tpu_torch.configs.config import trunk_steps
from shgvqa_tpu_torch.models import video_swin
from shgvqa_tpu_torch.utils import convert_video_swin
from test_torch_backbones_extra import (
    FEATURE_TOL,
    assert_trees_equal,
    jax_shape,
    load_through_trainer,
    meta_shape,
    one_thread,  # noqa: F401
    rel_err,
    round_trip,
    trunk_pair,
)

import convert_video_swin as tool_swin  # noqa: E402  (tools/, on the path)
import test_video_swin as jax_swin_test  # noqa: E402

TOY = dict(embed_dim=8, depths=(1, 2, 1), heads=(1, 2, 4), window=(2, 2, 2))


@pytest.fixture(scope="module", params=[(8, 32), (6, 40)],
                ids=["8x32", "6x40"])
def pair(request):
    t_len, hw = request.param
    x = np.random.RandomState(0).randn(2, t_len, hw, hw, 3).astype(
        np.float32)
    return (hw,) + trunk_pair(jax_swin.VideoSwin(**TOY),
                              video_swin.VideoSwin(torch.float32, **TOY), x)


def test_toy_features_match_jax(pair):
    hw, want, got, _, port = pair
    assert got.shape == want.shape
    t_in = 8 if hw == 32 else 6
    assert want.shape[1] == port.temporal_out(t_in) == trunk_steps(
        "video_swin_impl", t_in)
    assert want.shape[2] == port.spatial_out(hw)
    assert want.shape[-1] == port.out_channels
    assert rel_err(got, want) <= FEATURE_TOL


def test_convert_round_trip_is_bit_equal(pair):
    _, _, _, v, port = pair
    round_trip(v, port)


def test_window_helpers_are_jaxs():
    for w in ((2, 2, 2), (8, 7, 7), (4, 7, 7)):
        np.testing.assert_array_equal(video_swin._rel_pos_index(*w),
                                      jax_swin._rel_pos_index(*w))
    for args in ((4, 4, 4, (2, 2, 2), (1, 1, 1)),
                 (8, 14, 14, (8, 7, 7), (4, 3, 3)),
                 (4, 8, 8, (4, 4, 4), (0, 2, 2))):
        np.testing.assert_array_equal(video_swin._shift_mask(*args),
                                      jax_swin._shift_mask(*args))
    for size in ((4, 2, 2), (16, 56, 56), (8, 7, 7)):
        assert video_swin._adjust(size, (8, 7, 7), (4, 3, 3)) == \
            jax_swin._adjust(size, (8, 7, 7), (4, 3, 3))


def test_hub_converter_is_the_tools_and_loads(tmp_path):
    """The JAX test's toy official SwinTransformer3D: the port's converter
    gives the tool's tree, which loads strictly."""
    torch.manual_seed(0)
    m = jax_swin_test._ToySwin()
    with torch.no_grad():
        for p in m.parameters():
            p.uniform_(-0.2, 0.2)
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()
          if "relative_position_index" not in k}
    tree = convert_video_swin.convert(sd)
    assert_trees_equal(tree, tool_swin.convert(sd))
    jt = jax_swin_test
    load_through_trainer(tree, video_swin.VideoSwin(
        torch.float32, embed_dim=jt.EMBED, depths=jt.DEPTHS, heads=jt.HEADS,
        window=jt.WINDOW), tmp_path)


def test_full_width_shape_on_meta_is_jaxs():
    frames = (2, 32, 224, 224, 3)
    want = jax_shape("video_swin_impl", frames)
    assert want == (2, 16, 7, 7, 1024)
    assert meta_shape("video_swin_impl", frames) == want
