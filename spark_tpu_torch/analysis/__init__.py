"""Plan analysis: the legality rules the out-of-memory tier asks
(``legality.py``). The static analyzer and its gate come with ROADMAP
A12."""
