"""Swin backbone, ASPP, decoder and the assembled BiRefNet."""
