"""The plain reference: the decoder, the cross-entropy, blockwise top-k
with error feedback and Adam, in plain PyTorch, importing nothing of the
program."""
