"""Port of ``launch/specs.py`` (``repro_torch.launch.specs``) against
``repro.launch.specs``: the four spec functions for all ten archs at every
input shape each supports, at their full published configs -- the same tree
paths, shapes and dtypes exactly, every leaf a meta tensor (no storage, so
nothing is allocated: deepseek-v3-671b's whole tree is 2.7 TB in f32).  The
uncast ``params_struct`` is the cast one in f32 for every arch
(``tests/test_torch_optim_specs.py`` holds it against the reference's on
four archs).
"""
import pytest

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.launch import specs
from test_torch_optim_specs import _all_meta, _table

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("arch", configs.list_archs())
def test_specs_match_reference(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jp, tp = jspecs.params_struct(jcfg), specs.params_struct(cfg)
    assert _all_meta(tp)
    assert _table(tp) == _table(jp)
    assert {d for _, d in _table(tp).values()} == {"bfloat16", "float32"}
    # uncast: the init's own leaves, every one f32 (held against the
    # reference's eval_shape in test_uncast_struct_matches_reference)
    raw = specs.params_struct(cfg, cast=False)
    assert _all_meta(raw)
    assert _table(raw) == {k: (sh, "float32")
                           for k, (sh, _) in _table(tp).items()}
    for name in SHAPES:
        if not cfg.supports(name):
            continue
        shape = configs.get_shape(name)
        jshape = jconfigs.get_shape(name)
        if shape.kind == "train":
            got = specs.train_batch_specs(cfg, shape)
            want = jspecs.train_batch_specs(jcfg, jshape)
        elif shape.kind == "prefill":
            got = specs.prefill_batch_specs(cfg, shape)
            want = jspecs.prefill_batch_specs(jcfg, jshape)
            assert "labels" not in got
        else:
            got = specs.decode_specs(cfg, shape, tp)
            want = jspecs.decode_specs(jcfg, jshape, jp)
        assert _all_meta(got)
        assert _table(got) == _table(want), (arch, name)
