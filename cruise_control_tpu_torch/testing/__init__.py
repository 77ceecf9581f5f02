"""Fixture generators."""
