"""Launchers: the training launcher, ``train.py``.  (The reference's mesh
definitions, shardings and multi-pod dry-run are not ported yet: ROADMAP
A11.)"""
