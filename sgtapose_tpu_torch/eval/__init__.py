"""Evaluation: metrics, set-level analysis and the synthetic-video harness."""
