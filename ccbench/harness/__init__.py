"""harness"""
