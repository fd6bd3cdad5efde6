from . import microstrip
