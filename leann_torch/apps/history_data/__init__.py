"""Chrome and WeChat history readers."""
