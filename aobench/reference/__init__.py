"""The benchmark's plain reference: plain PyTorch, float64, imports nothing
of the program (``golden``: the frame; ``params``: its constants)."""
