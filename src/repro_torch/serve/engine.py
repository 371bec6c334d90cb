"""Batched generation: prefill + greedy/temperature decode loop."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import lead_device
from repro_torch.models.transformer import (ShardEnv, Transformer,
                                            decode_step, on_device,
                                            place_params, prefill)


class ServeEngine:
    """Generation with a dense, vlm, moe, hybrid or ssm LM on ``device``
    (None means CUDA), with ``params`` there or a copy of them (the
    caller's module does not move). Over ``env``'s mesh (``device`` then
    None) the parameters are placed once by ``param_shardings`` (views,
    no second copy, where the cells share their device; on a mesh of one
    cell, on its device), every pass runs on the cells, and the tokens
    are sampled on the mesh's first cell (the engine's ``device``), for
    every family it serves."""

    def __init__(self, cfg: ArchConfig, env: ShardEnv, params: Transformer,
                 device=None):
        self.cfg, self.env = cfg, env
        self.device = lead_device(env.mesh, device)
        self.params = place_params(params, env) if env.mesh is not None \
            else on_device(params, self.device)

    def generate(self, tokens, max_new: int = 32, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """tokens: (B, S) int prompt. Returns (B, max_new) generated ids
        (int32, on the engine's device): greedy (the first maximum, as
        ``jnp.argmax``) at temperature 0, else sampled from
        softmax(logits / temperature) with ``generator``.

        The prefill leaves room for the new tokens (a hybrid ring as long
        as the window at most; an ssm state needs none), so each decode
        step attends what ``prefill`` over the longer sequence would (see
        ``models.transformer``); the last token needs no decode step
        after it."""
        if temperature > 0.0 and generator is None:
            raise ValueError("generate: sampling needs a torch.Generator")
        tokens = torch.as_tensor(tokens, device=self.device)
        logits, cache = prefill(self.params, {"tokens": tokens}, self.cfg,
                                self.env,
                                cache_len=tokens.shape[1] + max_new - 1)
        out = []
        for i in range(max_new):
            last = logits[:, -1]
            if temperature > 0.0:
                probs = torch.softmax(last / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)
            else:
                nxt = torch.argmax(last, dim=-1, keepdim=True)
            nxt = nxt.to(torch.int32)
            out.append(nxt)
            if i + 1 < max_new:
                logits, cache = decode_step(self.params, cache,
                                            {"tokens": nxt}, self.cfg,
                                            self.env)
        return torch.cat(out, dim=1)
