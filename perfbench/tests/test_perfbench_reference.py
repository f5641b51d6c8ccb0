"""The plain references against the port's own forward on the CPU, on the
same weights (the benchmark's ``make_weights``), at the configurations'
smoke sizes.

The port computes in bfloat16 and the references in float32, so they are
held within a bfloat16 tolerance on the largest gap over the logits' RMS:
3% for the encoder and 6% for the decoder, two to three times the
largest gap seen at these sizes (1.0% and 3.5% over seeds 1-3). The same references in fp8
(the control) must land outside it, so each tolerance separates the
precision the configurations state from the one below.
"""
from __future__ import annotations

import torch

from perfbench.reference.decoder import Incremental, decoder_logits
from perfbench.reference.encoder import encoder_logits
from perfbench.reference.lowp import Precision
from perfbench.weights import make_weights
from repro_torch import configs
from repro_torch.models import RunConfig, build

INIT = {"embed_std": 1.0, "bias_std": 0.02, "norm_std": 0.1}


def _rel(a, b):
    return float((a - b).abs().max() / b.pow(2).mean().sqrt())


def _encoder(seed):
    cfg = configs.smoke("distilbert-imdb")
    model = build(cfg)
    w = make_weights(model.param_specs, INIT, seed, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (4, 48),
                        generator=torch.Generator().manual_seed(seed))
    spec = {"layer_norm_eps": cfg.norm_eps, "n_heads": cfg.n_heads}
    port, _ = model.forward(RunConfig(), w, {"tokens": tok})
    return port, w, tok, spec


def test_encoder_matches_the_port_and_fp8_does_not():
    for seed in (1, 2, 3):
        port, w, tok, spec = _encoder(seed)
        ref = encoder_logits(w, tok, spec)
        assert _rel(port, ref) < 0.03
        assert _rel(encoder_logits(w, tok, spec, Precision("fp8")),
                    ref) > 0.03


def test_encoder_blocks_of_rows_agree():
    _, w, tok, spec = _encoder(4)
    whole = encoder_logits(w, tok, spec, block=4)
    assert torch.allclose(encoder_logits(w, tok, spec, block=1), whole,
                          atol=1e-5, rtol=1e-5)


def _decoder(seed):
    cfg = configs.smoke("qwen2-7b")
    model = build(cfg)
    w = make_weights(model.param_specs, INIT, seed, "cpu")
    tok = torch.randint(1, cfg.vocab_size, (2, 24),
                        generator=torch.Generator().manual_seed(seed))
    spec = {"rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta}
    return cfg, model, w, tok, spec


def test_decoder_matches_the_port_and_fp8_does_not():
    for seed in (1, 2, 3):
        cfg, model, w, tok, spec = _decoder(seed)
        port, _ = model.forward(RunConfig(), w, {"tokens": tok})
        ref = torch.stack(decoder_logits(w, tok, spec, [range(24)] * 2))
        assert _rel(port, ref) < 0.06
        low = torch.stack(decoder_logits(w, tok, spec, [range(24)] * 2,
                                         Precision("fp8")))
        assert _rel(low, ref) > 0.06


def test_decoder_matches_the_ports_prefill_and_decode():
    cfg, model, w, tok, spec = _decoder(5)
    run = RunConfig(cache_pad=8)
    logits, cache = model.prefill(run, w, {"tokens": tok[:, :16]})
    steps = [logits]
    for i in range(16, 24):
        logits, cache = model.decode_step(run, w, cache,
                                          {"token": tok[:, i:i + 1]})
        steps.append(logits)
    port = torch.stack(steps, dim=1)                # positions 15..23
    ref = torch.stack(decoder_logits(w, tok, spec, [range(15, 24)] * 2))
    assert _rel(port, ref) < 0.06


def test_decoder_extended_token_by_token_equals_the_full_forward():
    _, _, w, tok, spec = _decoder(6)
    full = decoder_logits(w, tok, spec, [range(24)] * 2)
    for b in range(2):
        inc = Incremental(w, spec)
        parts = [inc.step(tok[b, :10])]
        parts += [inc.step(tok[b, i:i + 1]) for i in range(10, 24)]
        assert torch.allclose(torch.cat(parts), full[b], atol=1e-4,
                              rtol=1e-4)


def test_references_use_no_tf32_and_fp8_rounds():
    Precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    from perfbench.reference.lowp import round_fp8
    r = round_fp8(x, -1)
    assert not torch.equal(r, x)
    assert float(((r - x).abs() / x.abs().amax(-1, keepdim=True)).max()) \
        < 2 ** -4
