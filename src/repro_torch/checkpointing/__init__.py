from . import store
from .store import latest_step, restore, save
