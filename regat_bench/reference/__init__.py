"""The plain reference: ReGAT in plain PyTorch (regat.py), its parameter
layout (params.py) and a batch gathered from the raw inputs (data.py). It
imports torch, numpy and the standard library only."""
