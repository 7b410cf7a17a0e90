"""Training-side modules; so far the video-engine LFB build."""
