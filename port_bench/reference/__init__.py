"""The benchmark's plain reference: the model's inference forward and the
serving engine's bucket rule, copied from their math; nothing of the program
under test is imported here."""
