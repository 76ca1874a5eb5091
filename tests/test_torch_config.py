"""The port's `VFLConfig` takes every field of the reference's, with the
reference's names, order and defaults; its only extra field is
`device`."""
import dataclasses

from repro.core import trainer as jtrainer

from repro_torch.core import trainer as ttrainer


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_vflconfig_fields_match_reference():
    ref, port = _fields(jtrainer.VFLConfig), _fields(ttrainer.VFLConfig)
    assert [f for f in port if f[0] != "device"] == ref
    assert port[-1] == ("device", "cuda")
    cfg = ttrainer.VFLConfig(record_every=1, checkpoint_every=0,
                             wire_compression="none")
    assert (cfg.record_every, cfg.checkpoint_every,
            cfg.wire_compression) == (1, 0, "none")
