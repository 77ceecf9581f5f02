"""ccbench"""
