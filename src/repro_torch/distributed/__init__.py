"""Distributed optimization.  So far the gradient compression that the
train step runs between the backward and AdamW (``collectives.py``); the
collectives themselves come with the port's meshes."""
