"""Pipelines: CLI entry points (scoring, training, extraction, merge, leaderboard)."""
