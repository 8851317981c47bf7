"""Supported-language whitelist and normalization (reference
qwen_asr_gguf/inference/utils.py:5-55). ISO-639-1 map serves the
OpenAI-compatible server (reference serve_openai_gguf.py:31-42)."""

from __future__ import annotations

from typing import List, Optional

SUPPORTED_LANGUAGES: List[str] = [
    "Chinese", "English", "Cantonese", "Arabic", "German", "French",
    "Spanish", "Portuguese", "Indonesian", "Italian", "Korean", "Russian",
    "Thai", "Vietnamese", "Japanese", "Turkish", "Hindi", "Malay", "Dutch",
    "Swedish", "Danish", "Finnish", "Polish", "Czech", "Filipino",
    "Persian", "Greek", "Romanian", "Hungarian", "Macedonian",
]

ISO639_1_TO_NAME = {
    "zh": "Chinese", "en": "English", "yue": "Cantonese", "ar": "Arabic",
    "de": "German", "fr": "French", "es": "Spanish", "pt": "Portuguese",
    "id": "Indonesian", "it": "Italian", "ko": "Korean", "ru": "Russian",
    "th": "Thai", "vi": "Vietnamese", "ja": "Japanese", "tr": "Turkish",
    "hi": "Hindi", "ms": "Malay", "nl": "Dutch", "sv": "Swedish",
    "da": "Danish", "fi": "Finnish", "pl": "Polish", "cs": "Czech",
    "tl": "Filipino", "fa": "Persian", "el": "Greek", "ro": "Romanian",
    "hu": "Hungarian", "mk": "Macedonian",
}


def normalize_language_name(language: str) -> str:
    """'cHINese' -> 'Chinese' (reference utils.py:38-48)."""
    if language is None:
        raise ValueError("language is None")
    s = str(language).strip()
    if not s:
        raise ValueError("language is empty")
    return s[:1].upper() + s[1:].lower()


def validate_language(language: str) -> None:
    if language not in SUPPORTED_LANGUAGES:
        raise ValueError(
            f"Unsupported language: {language}. Supported: {SUPPORTED_LANGUAGES}"
        )


def resolve_language(language: Optional[str]) -> Optional[str]:
    """Accept ISO-639-1 codes or names; None passes through."""
    if language is None or not str(language).strip():
        return None
    s = str(language).strip()
    if s.lower() in ISO639_1_TO_NAME:
        return ISO639_1_TO_NAME[s.lower()]
    name = normalize_language_name(s)
    validate_language(name)
    return name
