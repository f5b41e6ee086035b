"""Decoders of the port. Only the latent PCA of the pooled decoder is
ported so far, for the CTC driver; the classical decoders are ROADMAP
queue 1, item 6."""
