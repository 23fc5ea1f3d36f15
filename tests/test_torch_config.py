"""The port's HOCON-lite parser (graphsage_torch.utils.config) against the
JAX package's (graphsage_tpu.utils.config): every text of
tests/test_config.py through both parsers, equal Configs or the same error
type and message."""

import pytest

from graphsage_tpu.utils import config as jax_config
from graphsage_torch.utils import config

SAMPLE = """
file_path {
\tworkdir = ./data/
\tcora_content = ${file_path.workdir}cora/cora.content
\tcora_cite = ${file_path.workdir}cora/cora.cites
}

// comment
setting {
\tnum_layers = 2
\thidden_emb_size = 128
}
"""

DEEP_CHAIN = "".join([f"k{i} = ${{k{i - 1}}}\n" for i in range(12, 0, -1)]
                     + ["k0 = done\n"])

TEXTS = {
    "subset": SAMPLE,
    "colon_separator": "setting {\nnum_layers : 3\nurl = \"http://x/y\"\n}",
    "separator_before_brace": "setting = {\nnum_layers = 2\n}\n"
                              "other : {\nlr : 0.7\n}\n",
    "plus_equals_inside_quotes": 'cmd = "make FLAGS+=-O2"\n',
    "comments_and_quotes": "a = 'x # y' # trailing\nb = 1.5 // c\n"
                           "c = TRUE\n",
    "deep_chain": DEEP_CHAIN,
    "unclosed_block": "setting {\nnum_layers = 2\n",
    "unmatched_brace": "}\n",
    "cannot_parse": "just words\n",
    "include": 'include "other.conf"\n',
    "plus_equals_in_block": "setting {\na += 2\n}",
    "plus_equals": "a += 2\n",
    "array": "xs = [1, 2, 3]\n",
    "unresolved": "a = ${nope.missing}/x\n",
    "cycle": "a = ${b}\nb = ${a}\n",
    "self_cycle": "solo = ${solo}\n",
}


def _parse(module, text):
    try:
        return "ok", module.parse_hocon(text)
    except ValueError as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(TEXTS))
def test_parse_hocon_matches_jax(name):
    text = TEXTS[name]
    kind, got = _parse(config, text)
    want_kind, want = _parse(jax_config, text)
    assert kind == want_kind
    if kind == "ok":
        assert dict(got._values) == dict(want._values)
        assert type(got).__name__ == "Config"
    else:
        assert got == want


def test_load_config_reads_a_file(tmp_path):
    path = tmp_path / "exp.conf"
    path.write_text(SAMPLE)
    cfg = config.load_config(str(path))
    assert cfg["setting.num_layers"] == 2
    assert cfg.get("setting.hidden_emb_size") == 128
    assert cfg.get("setting.missing", 7) == 7
    assert "file_path.cora_cite" in cfg
    assert dict(cfg._values) == dict(
        jax_config.load_config(str(path))._values)


def test_one_line_block_is_rejected_where_jax_misparses():
    """A block written on one line is outside the subset.  The JAX parser
    reads it as one garbled key; the port's rejects it by name."""
    text = "setting { num_layers = 2 }\n"
    assert dict(jax_config.parse_hocon(text)._values) == {
        "setting { num_layers": "2 }"}
    with pytest.raises(config.HoconSubsetError, match="one line"):
        config.parse_hocon(text)
    # a substitution's braces are not a block
    assert config.parse_hocon("a = x\nb = ${a}y\n")["b"] == "xy"
