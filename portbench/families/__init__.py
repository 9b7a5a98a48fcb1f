"""One module per configuration ``family``: how a cell builds and drives
the program under test, and which reference checks it."""
