from .chat_completions import (
    ChatTemplatingProcessor,
    RenderRequest,
    RenderResponse,
    FetchTemplateRequest,
)

__all__ = [
    "ChatTemplatingProcessor",
    "RenderRequest",
    "RenderResponse",
    "FetchTemplateRequest",
]
