from rt_depth_map.cli import main

raise SystemExit(main())
