from . import store
from .store import elastic_reshard, latest_step, restore, save
