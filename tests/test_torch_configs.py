"""The port's configs equal the JAX package's field for field."""

import dataclasses

import pytest

import repro.configs as jcfg
import repro_torch.configs as tcfg

ARCHS = sorted(jcfg._ALIASES)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_get_config_field_for_field(name, smoke):
    want = jcfg.get_config(name, smoke=smoke)
    got = tcfg.get_config(name, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.vocab_padded) == (want.hd, want.vocab_padded)
    assert got.with_sliding_window(512).name == want.with_sliding_window(512).name


def test_shapes_run_config_and_names():
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    assert dataclasses.asdict(tcfg.RunConfig()) == \
        dataclasses.asdict(jcfg.RunConfig())
    assert tcfg.arch_names() == jcfg.arch_names()
    with pytest.raises(ValueError):
        tcfg.get_config("no-such-arch")
