"""The benchmark's tests: on the CPU at small sizes, plus a few marked
``cuda`` that decide inside the test whether a card is there."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
