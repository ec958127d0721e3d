"""The benchmark's plain reference: a NumPy semi-naive fixpoint over the
rule file and a NumPy evaluator of basic graph patterns over the query
files.  It works from the columns and the term list the harness
generated, and imports nothing of the program under test."""
