"""Splitting a batch of chains over several devices (:mod:`.mesh`)."""
