"""Every CLI of the port has the JAX package's flags with the same defaults.

A canonical run is a CLI's defaults plus ``--seed`` (and, for the cGlow,
the JAX package's own command), so a default that drifts between the two
packages changes the recipe without a word.  Each case builds both
packages' parsers: a CLI's ``Parser`` class where it has one, else the
parser its ``main`` builds, taken at its ``parse_args`` call (``main``
does nothing before it and is stopped there).  It then compares every
shared flag's default, requires every JAX flag in the port, and names
the port's own flags, so that a new one fails here until it is listed.
"""

import argparse
import importlib

import pytest

PORT_ONLY = {
    "train_codec_mixed_residual": {"device"},
    "train_codec_max_likelihood": {"device", "concat_free"},
    "train_cglow_reverse_kl": {"device"},
    "solve_fc_mixed_residual": {"device"},
    "solve_conv_mixed_residual": {"device", "init_weights"},
    "post_cglow": {"device"},
    "predict_codec": {"device"},
    "predict_cglow": {"device"},
    "make_dataset": {"device"},
    "import_torch_ckpt": {"device"},
}


class _Built(Exception):
    """Carries the parser a ``main`` built, out of its ``parse_args``."""


def _parser(module: str) -> argparse.ArgumentParser:
    mod = importlib.import_module(module)
    if hasattr(mod, "Parser"):
        return mod.Parser()

    def stop(self, *args, **kwargs):
        raise _Built(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Built) as built:
            mod.main([])
    return built.value.args[0]


def _defaults(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("cli", sorted(PORT_ONLY))
def test_cli_defaults_match_jax(cli):
    jax = _defaults(_parser(f"pde_surrogate_tpu.cli.{cli}"))
    port = _defaults(_parser(f"pde_surrogate_torch.cli.{cli}"))
    assert set(jax) - set(port) == set(), "JAX flags missing in the port"
    assert set(port) - set(jax) == PORT_ONLY[cli]
    assert len(jax) > 3
    differ = {k: (jax[k], port[k]) for k in jax if jax[k] != port[k]}
    assert differ == {}
