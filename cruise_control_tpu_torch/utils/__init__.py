"""Host utilities: shared secrets and TLS contexts for the admin socket."""
