"""Model facade: the interface the serving engine talks to, limited to
what the engine calls.  The counterpart of `repro.models.model`: it
dispatches on the family, xLSTM (`models.xlstm`) or the transformer
(`models.transformer`: the decoders, Hymba and the encoder-decoder), for
every config the port runs (`params.require_supported`)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import params as params_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xl


def _no_kv(cfg: ArchConfig, name: str) -> None:
    if cfg.block == "xlstm":
        raise NotImplementedError(
            f"{name}: xlstm has no KV cache (its state is recurrent)")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    def init(self, generator: torch.Generator) -> params_lib.Params:
        return params_lib.init_params(self.cfg, generator, self.device)

    def prefill(self, params, tokens, lengths, prefix_embeds=None,
                src_embeds=None):
        """Bucketed prefill; a vision model takes its prefix embeddings
        ahead of the tokens, an encoder-decoder its encoder's input
        frames.  `lengths` None: every row is exactly `tokens.shape[1]`
        long (the exact-length prefill of a recurrent family, whose state
        would absorb padding).  xLSTM takes its tokens alone, as in
        JAX."""
        if self.cfg.block == "xlstm":
            return xl.prefill(params, self.cfg, tokens)
        return tf.prefill(params, self.cfg, tokens, lengths=lengths,
                          prefix_embeds=prefix_embeds, src_embeds=src_embeds)

    def prefill_suffix(self, params, cache, tokens, offsets, lengths):
        """Extend per-row cache views with suffix tokens at per-row
        offsets (the prefix-cache admission)."""
        _no_kv(self.cfg, "prefill_suffix")
        return tf.prefill_suffix(params, self.cfg, cache, tokens, offsets,
                                 lengths)

    def decode(self, params, cache, token, pos):
        """One step; xLSTM's ignores `pos` (its state has no positions)."""
        if self.cfg.block == "xlstm":
            return xl.decode_step(params, self.cfg, cache, token)
        return tf.decode_step(params, self.cfg, cache, token, pos)

    def decode_paged(self, params, cache, token, pos, page_table,
                     write_table):
        _no_kv(self.cfg, "decode_paged")
        return tf.decode_step_paged(params, self.cfg, cache, token, pos,
                                    page_table, write_table)

    def verify_paged(self, params, cache, tokens, pos, page_table,
                     write_table):
        """The speculative verify: Q tokens a row in one paged forward,
        causal by absolute position."""
        _no_kv(self.cfg, "verify_paged")
        return tf.spec_verify_paged(params, self.cfg, cache, tokens, pos,
                                    page_table, write_table)


def build(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    """A model on `device` ("cuda" unless given)."""
    params_lib.require_supported(cfg)
    return Model(cfg, resolve_device(device))
