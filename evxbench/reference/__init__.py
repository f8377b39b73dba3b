"""The benchmark's plain reference codec: a frozen copy of the evx1
numpy engine (colour conversion, motion search, transform, quantizer,
deblock, block table, stream header) and of the Python slice coder.

It imports numpy alone and nothing of the program under test, so a later
change to the program cannot change what its output is held to. Each
module keeps the docstring of the module it was copied from.
"""
