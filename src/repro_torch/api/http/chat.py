"""Chat abstraction for the wire protocol — messages, templates, codec.

The engines speak token ids; OpenAI-compatible clients speak role-tagged
message strings.  This module bridges the two:

* `ChatMessage` — one (role, content) turn; roles follow the OpenAI set.
* `ChatTemplate` — a per-model-family prompt format (llama3 headers,
  gemma turns, ChatML for the qwen/deepseek lineage, a plain fallback)
  rendering a conversation to one deterministic prompt string.  The
  registry resolves a template by model-name prefix, so reduced test
  variants ("llama3.2-1b-reduced") pick up their family automatically.
* byte-level codec — `encode_text`/`decode_tokens` map strings to token
  ids and back.  There is no learned tokenizer in this reproduction, so
  the wire layer uses UTF-8 bytes as ids (folded into the vocab when it
  is smaller than 256); ids beyond the byte range decode to U+FFFD.

Prefix awareness: vision-fronted and meta-token models spend
`n_prefix_tokens`/`n_meta_tokens` cache positions *before* the prompt
(the engine injects those embeddings itself).  Templates therefore never
emit prefix placeholders as tokens — vision models only get a textual
`image_marker` anchor — and `prefix_budget()` exposes the reserved count
so the service layer can validate context against
`max_len - prefix_budget(cfg)`, matching the Gateway's own accounting.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig

ROLES = ("system", "user", "assistant")

_REPLACEMENT = b"\xef\xbf\xbd"          # UTF-8 encoding of U+FFFD


# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ChatMessage:
    """One conversation turn."""
    role: str
    content: str

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, "
                             f"got {self.role!r}")
        if not isinstance(self.content, str):
            raise ValueError("content must be a string")


# --------------------------------------------------------------------- #
def encode_text(text: str, vocab: int = 256) -> Tuple[int, ...]:
    """Text -> token ids: UTF-8 bytes, folded into small vocabularies.
    Every catalog model has vocab >= 256, so encoding round-trips; the
    fold only matters for hand-built toy configs."""
    v = max(int(vocab), 1)
    return tuple(b % v for b in text.encode("utf-8"))


def decode_tokens(tokens: Iterable[int]) -> str:
    """Token ids -> text.  Ids in the byte range decode as UTF-8 (lossy
    sequences become U+FFFD); ids beyond it (sampled from a larger
    vocab) decode to U+FFFD placeholders."""
    buf = bytearray()
    for t in tokens:
        t = int(t)
        if 0 <= t < 256:
            buf.append(t)
        else:
            buf.extend(_REPLACEMENT)
    return buf.decode("utf-8", errors="replace")


# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    """One model family's prompt format.  `turn` and `generation_open`
    are format strings over {role} / {content}; `role_names` renames
    wire roles to family-native ones (gemma says "model", not
    "assistant")."""
    name: str
    turn: str
    generation_open: str
    bos: str = ""
    image_marker: str = ""          # textual anchor for vision frontends
    role_names: Tuple[Tuple[str, str], ...] = ()

    def _role(self, role: str) -> str:
        return dict(self.role_names).get(role, role)

    def render_text(self, messages: Sequence[ChatMessage], *,
                    vision: bool = False) -> str:
        """Render a conversation to the family's prompt string, ending
        with the assistant-generation cue."""
        parts: List[str] = [self.bos] if self.bos else []
        if vision and self.image_marker:
            parts.append(self.image_marker)
        for m in messages:
            parts.append(self.turn.format(role=self._role(m.role),
                                          content=m.content))
        parts.append(self.generation_open)
        return "".join(parts)


LLAMA3 = ChatTemplate(
    name="llama3",
    bos="<|begin_of_text|>",
    turn="<|start_header_id|>{role}<|end_header_id|>\n\n{content}"
         "<|eot_id|>",
    generation_open="<|start_header_id|>assistant<|end_header_id|>\n\n",
    image_marker="<|image|>",
)

GEMMA = ChatTemplate(
    name="gemma",
    bos="<bos>",
    turn="<start_of_turn>{role}\n{content}<end_of_turn>\n",
    generation_open="<start_of_turn>model\n",
    image_marker="<start_of_image>",
    role_names=(("assistant", "model"),),
)

CHATML = ChatTemplate(
    name="chatml",
    turn="<|im_start|>{role}\n{content}<|im_end|>\n",
    generation_open="<|im_start|>assistant\n",
    image_marker="<|vision_start|><|image_pad|><|vision_end|>",
)

PLAIN = ChatTemplate(
    name="plain",
    turn="{role}: {content}\n",
    generation_open="assistant:",
    image_marker="[image]\n",
)

# model-name prefix -> template; longest matching prefix wins, so
# reduced()/derived names ("gemma3-1b-reduced") resolve like their base
_REGISTRY: Dict[str, ChatTemplate] = {
    "llama": LLAMA3,
    "gemma": GEMMA,
    "qwen": CHATML,
    "deepseek": CHATML,
    "olmo": CHATML,
    "phi": CHATML,
}


def register_template(prefix: str, template: ChatTemplate):
    """Install (or override) the template for a model-name prefix."""
    _REGISTRY[prefix] = template


def template_for(model: str) -> ChatTemplate:
    best = ""
    for prefix in _REGISTRY:
        if model.startswith(prefix) and len(prefix) > len(best):
            best = prefix
    return _REGISTRY[best] if best else PLAIN


# --------------------------------------------------------------------- #
def prefix_budget(cfg: Optional[ArchConfig]) -> int:
    """Cache positions the engine reserves ahead of the prompt (vision /
    meta prefix embeddings) — they count against the replica context."""
    if cfg is None:
        return 0
    return int(getattr(cfg, "n_prefix_tokens", 0)
               + getattr(cfg, "n_meta_tokens", 0))


def render_prompt(model: str, messages: Sequence[ChatMessage],
                  cfg: Optional[ArchConfig] = None) -> Tuple[int, ...]:
    """Render a conversation to prompt token ids for `model`.  With a
    catalog `cfg` the encoding folds into the model's vocab and vision
    frontends get their image anchor."""
    tmpl = template_for(model)
    vision = cfg is not None and getattr(cfg, "frontend", "") == "vision"
    text = tmpl.render_text(messages, vision=vision)
    return encode_text(text, cfg.vocab if cfg is not None else 256)
