"""Analyzer: goals, the batched solver and the goal-priority optimizer."""
