"""Batched evaluator and transdimensional McMC sampler."""
