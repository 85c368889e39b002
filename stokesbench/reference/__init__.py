"""The plain reference of every configuration, set up from the
configuration's file (its `problem`), so that one reference serves every
configuration and each of a configuration's cells.  The file's `reference`
key names the module that judges its frames: `loop` (the default: the
frame loop of `loop.py` on the plain BEM frame of `bem.py`, a second dense
solve of each checked frame) or `streamed` (`streamed.py`: the residual of
the candidate's solution, the operators applied a block of rows at a time,
for frames whose operators no single card holds).  Each module gives
`numbers`, `Reference`, `expected`, `judge` and `Control`.  Nothing here
imports the program."""
