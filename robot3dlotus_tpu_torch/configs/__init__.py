from .node import ConfigNode, get_config
