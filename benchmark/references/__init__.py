"""Plain references: straightforward PyTorch implementations of what each
configuration computes, importing nothing of the program."""
