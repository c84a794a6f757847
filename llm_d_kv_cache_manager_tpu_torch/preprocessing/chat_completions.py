"""OpenAI chat-completions → flattened prompt, matching engine templating.

Functional parity with the reference's three-language bridge
(``pkg/preprocessing/chat_completions``: Go → embedded-CPython C shim
(``cgo_functions.c``) → Python ``render_jinja_template_wrapper.py``). Our
control plane is already Python, so the CPython-embedding layer collapses to
in-process calls while keeping the same surface:

- ``render_chat_template(request)`` → rendered prompt(s) via
  ``transformers.utils.chat_template_utils.render_jinja_template`` —
  the same function serving engines use, so the flattened prompt (and hence
  the block-hash chain) lines up;
- ``fetch_chat_template(model)`` → template + special-token kwargs from
  ``AutoTokenizer`` (reference ``render_jinja_template_wrapper.py:130-188``),
  with a thread-locked cache keyed ``model:revision:token``;
- ``initialize()/finalize()/clear_caches()`` for API parity with the
  reference's interpreter lifecycle (here they only manage the caches).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from ..utils import get_logger

log = get_logger("preprocessing.chat_completions")


@dataclass
class RenderRequest:
    conversations: list[list[dict[str, str]]]
    chat_template: str
    tools: Optional[list] = None
    documents: Optional[list] = None
    add_generation_prompt: bool = True
    continue_final_message: bool = False
    # special-token kwargs collected at fetch time (bos/eos etc.)
    template_vars: dict[str, Any] = field(default_factory=dict)


@dataclass
class RenderResponse:
    rendered_chats: list[str]


@dataclass
class FetchTemplateRequest:
    model: str
    revision: Optional[str] = None
    token: Optional[str] = None
    chat_template: Optional[str] = None  # explicit override


_SPECIAL_TOKEN_ATTRS = (
    "bos_token",
    "eos_token",
    "pad_token",
    "unk_token",
    "sep_token",
    "cls_token",
    "mask_token",
)


class ChatTemplatingProcessor:
    def __init__(self):
        self._cache_lock = threading.Lock()
        self._template_cache: dict[str, tuple[str, dict[str, Any]]] = {}  # guarded_by: _cache_lock
        self._initialized = False

    # -- lifecycle (parity with the reference's interpreter management) -----
    def initialize(self) -> None:
        self._initialized = True

    def finalize(self) -> None:
        self._initialized = False
        self.clear_caches()

    def clear_caches(self) -> None:
        with self._cache_lock:
            self._template_cache.clear()

    # -- rendering ----------------------------------------------------------
    def render_chat_template(self, request: RenderRequest) -> RenderResponse:
        from transformers.utils.chat_template_utils import render_jinja_template

        rendered = []
        for conversation in request.conversations:
            out = render_jinja_template(
                conversations=[conversation],
                chat_template=request.chat_template,
                tools=request.tools,
                documents=request.documents,
                add_generation_prompt=request.add_generation_prompt,
                continue_final_message=request.continue_final_message,
                **request.template_vars,
            )
            # Depending on version the helper returns str or (list, indices).
            if isinstance(out, tuple):
                out = out[0]
            if isinstance(out, list):
                rendered.extend(out)
            else:
                rendered.append(out)
        return RenderResponse(rendered_chats=rendered)

    # -- template fetching --------------------------------------------------
    def fetch_chat_template(self, request: FetchTemplateRequest) -> tuple[str, dict[str, Any]]:
        """Return (template, special-token kwargs) for a model, cached."""
        if request.chat_template:
            return request.chat_template, {}

        cache_key = f"{request.model}:{request.revision}:{request.token}"
        with self._cache_lock:
            hit = self._template_cache.get(cache_key)
        if hit is not None:
            return hit

        from transformers import AutoTokenizer

        kwargs: dict[str, Any] = {"trust_remote_code": True}
        if request.revision:
            kwargs["revision"] = request.revision
        if request.token:
            kwargs["token"] = request.token
        tokenizer = AutoTokenizer.from_pretrained(request.model, **kwargs)
        template = getattr(tokenizer, "chat_template", None)
        if not template:
            raise ValueError(f"model {request.model!r} has no chat template")

        template_vars = {}
        for attr in _SPECIAL_TOKEN_ATTRS:
            val = getattr(tokenizer, attr, None)
            if val is not None:
                template_vars[attr] = str(val)

        with self._cache_lock:
            self._template_cache[cache_key] = (template, template_vars)
        return template, template_vars
