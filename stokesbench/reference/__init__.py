"""The plain reference of every configuration: the frame loop of `loop.py`
on the plain BEM frame of `bem.py`, set up from the configuration's file
(its `problem`), so that one reference serves every configuration and
both of a configuration's cells.  Nothing here imports the program."""
