"""Analysis tools of the port: the lockdep runtime lock-order checker."""
