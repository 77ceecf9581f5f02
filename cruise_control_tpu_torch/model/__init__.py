"""Tensor cluster model: state, snapshot codec, segment helpers and stats."""
