"""Evaluation harness (ref: JLM:decoder/ eval script — SURVEY.md §5.5)."""

from jlm.eval.conversion import evaluate_conversion, ConversionReport  # noqa: F401
